"""The virtual clock the simulation installs over `utils/clock.py`.

One instance owns all of simulated time.  ``t`` is the global (true)
timeline; ``offset`` is the ACTING host's clock skew, set by the kernel
before each actor step — so wall stamps written by a skewed host
(`lease_unix`, heartbeat ``unix``, route ``at``) carry that host's
drifted view while the kernel keeps judging ground truth on ``t``.

``sleep`` advances ``t`` instead of blocking: a retry backoff ladder or
a poll loop inside production code costs virtual time only, which is
what makes a 500-seed soak finish in seconds of wall time.
"""

from __future__ import annotations

from ...utils import clock as _clock

#: virtual epoch, deliberately in the future of any real wall clock the
#: test venue can have: a stray REAL-mtime file (a tmp the sim didn't
#: stamp) reads as ancient under virtual time, and the only consumer of
#: that age (the leaseless-claim grace window) degrades by requeueing an
#: idempotent job — safe, and deterministic in every comparison that
#: matters
SIM_EPOCH = 2_000_000_000.0


class SimClock(_clock.Clock):
    """Virtual wall + monotonic time with a per-actor skew offset."""

    def __init__(self, start: float = SIM_EPOCH):
        self.t = float(start)        # ground-truth timeline
        self.offset = 0.0            # acting host's skew (kernel-set)
        self.slept = 0.0             # total virtual sleep (diagnostics)

    def now(self) -> float:
        return self.t + self.offset

    def monotonic(self) -> float:
        # monotonic is only ever used for LOCAL durations; skew (a wall
        # phenomenon) must not leak into it
        return self.t

    def sleep(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        self.t += s
        self.slept += s

    def advance(self, seconds: float) -> None:
        """Kernel-driven time advance (scheduler `dt`, not a sleep)."""
        self.t += max(0.0, float(seconds))
