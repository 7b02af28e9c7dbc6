"""Deterministic fleet simulation: seed-driven interleaving search over
the whole torch-free control plane, with schedule shrinking.

The port's copy of ``kafka_specification_tpu/resilience/simfleet/``,
driving the port's modules; one seed gives one run digest in either
package.

The chaos grammar (`resilience/faults`) and crashcheck
(`resilience/crashcheck`) prove the fleet survives *hand-picked* faults
at *hand-picked* points; this package searches the faults nobody picked.
It runs the REAL router + queue + daemon(stub-engine) + federated-cache
code in one process under a virtual clock (`utils/clock.py`) and a
seeded discrete-event scheduler that owns every yield point — sleeps,
lease/heartbeat stamps, fs-op faults via the `durable_io` hook, per-host
clock skew, host kill/partition — so one integer seed determines the
entire interleaving, FoundationDB-style.

After every run a set of invariant oracles judges the final state and
the event history; any violation is shrunk (event-subset + delay
reduction) to a minimal schedule persisted as a ``kspec-simfleet/1``
repro, replayable bit-for-bit via ``cli simfleet replay``.

Layout:

``simclock``  the virtual `Clock` (wall + per-host skew offset +
              sleep-advances-time)
``kernel``    actors, actions, fault injection, the event log, one run
``oracles``   the invariant checks (verdict-exactly-once, live-claim
              never stolen, single runnable copy, cache-torn-read,
              bounded drain)
``search``    seed sweep, ddmin shrinking, repro persist/load/replay
"""

from .simclock import SIM_EPOCH, SimClock
from .kernel import SimConfig, SimKernel, run_schedule, run_seed
from .search import (
    REPRO_SCHEMA,
    load_repro,
    replay_repro,
    save_repro,
    shrink,
    sweep_seeds,
)

__all__ = [
    "SIM_EPOCH", "SimClock",
    "SimConfig", "SimKernel", "run_seed", "run_schedule",
    "REPRO_SCHEMA", "sweep_seeds", "shrink",
    "save_repro", "load_repro", "replay_repro",
]
