"""The one injectable clock/sleep boundary of the control plane.

The port's own copy of ``kafka_specification_tpu/utils/clock.py``.  Every
timing decision the control plane makes (retry backoff, heartbeat
freshness, supervisor stall detection and restart backoff) calls
:func:`now`/:func:`monotonic`/:func:`sleep` here rather than ``time``
raw, so a harness can install a virtual clock that owns time wholesale:
the same production code on a simulated schedule, where a stall of many
minutes costs no wall time.

With the default :class:`SystemClock` installed every call is a direct
pass-through to ``time``: one attribute hop of overhead, no change of
behaviour.  The pass-through resolves ``time.time``/``time.sleep`` at call
time, so tests that monkeypatch attributes on the ``time`` module keep
working through the shim.

The ``raw-clock`` lint (``analysis/clock_lint.py``, wired into ``cli
analyze``) pins the boundary: a raw ``time.time()``/``time.sleep()``/
``time.monotonic()`` in a clock-migrated module is a HIGH finding unless
the site carries a reasoned ``# kspec: allow(raw-clock)`` tag.

Clock contract:

``now()``        wall-clock seconds (the thing cross-host metadata
                 stamps carry: heartbeat unix, event stamps)
``monotonic()``  monotonic seconds for local deadlines and durations
                 (never compared across processes or hosts)
``sleep(s)``     blocks for ``s`` seconds; a virtual clock advances its
                 own time instead, so a retry backoff or a poll loop costs
                 simulated time, not wall time

Leaf contract: standard library only, no import of the package (the
supervisor imports it, and the supervisor imports no torch).
"""

from __future__ import annotations

import time as _time

__all__ = [
    "Clock", "SystemClock", "SYSTEM",
    "install", "get", "now", "monotonic", "sleep",
]


class Clock:
    """The interface a virtual clock implements (duck-typed; this base
    doubles as documentation).  All three methods are required."""

    def now(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Real time.  Late-bound lookups on the ``time`` module so test
    monkeypatching of ``time.sleep``/``time.time`` still intercepts."""

    def now(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


#: the production default, also importable directly for code that must
#: read REAL time regardless of any installed virtual clock
SYSTEM = SystemClock()

_CLOCK = SYSTEM


def install(clock):
    """Install a clock (``None`` restores :data:`SYSTEM`).  Returns the
    previous clock so callers can restore it.  Process-global by design:
    the control plane under simulation is single-threaded, and the
    production default is never installed over."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = SYSTEM if clock is None else clock
    return prev


def get() -> Clock:
    return _CLOCK


def now() -> float:
    """Wall-clock seconds via the installed clock."""
    return _CLOCK.now()


def monotonic() -> float:
    """Monotonic seconds via the installed clock."""
    return _CLOCK.monotonic()


def sleep(seconds: float) -> None:
    """Sleep via the installed clock (virtual clocks advance instead)."""
    _CLOCK.sleep(seconds)
