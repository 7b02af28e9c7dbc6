"""Resilience: fault injection, checkpoints, the level digest chain, the
retry ladder, resource governance and the auto-resume supervisor (the
port's own copies of the JAX package's jax-free resilience modules):

- `faults`      — deterministic fault injection (the `KSPEC_FAULT` grammar);
- `checkpoints` — checksummed, keep-last-K rotating checkpoint store with
                  atomic promote and fallback to the newest verifying
                  generation;
- `retry`       — failure classification (transient, device allocation
                  failure, compile OOM, other; CUDA errors by class) and
                  the chunk retry ladder;
- `resources`   — disk/RSS budgets, the level deadline, the typed
                  RESOURCE_EXHAUSTED exit and the supervisor's --reclaim
                  sweep;
- `integrity`   — the level digest chain, shadow sampling, the typed
                  INTEGRITY_VIOLATION exit 76 and the chain validator;
- `heartbeat`   — the JSONL heartbeat envelope of the per-level stream;
- `supervisor`  — the auto-resume run loop behind `cli check --resilient`.

Nothing here imports torch: the supervisor's parent must never hold a
CUDA context.
"""

from .checkpoints import CheckpointCorrupt, CheckpointStore
from .faults import FaultPlan, InjectedCrash, InjectedFault, corrupt_file
from .heartbeat import append_jsonl, heartbeat_record
from .integrity import EXIT_INTEGRITY, IntegrityError, LevelDigestChain
from .resources import (
    EXIT_RESOURCE_EXHAUSTED,
    ResourceExhausted,
    ResourceGovernor,
    is_disk_full,
    reclaim_disk,
)
from .retry import ChunkRetryHandler, RetryPolicy, classify
from .supervisor import STALL_RC, SupervisorConfig, classify_exit, supervise

__all__ = [
    "CheckpointCorrupt",
    "CheckpointStore",
    "ChunkRetryHandler",
    "EXIT_INTEGRITY",
    "EXIT_RESOURCE_EXHAUSTED",
    "FaultPlan",
    "IntegrityError",
    "LevelDigestChain",
    "InjectedCrash",
    "InjectedFault",
    "ResourceExhausted",
    "ResourceGovernor",
    "RetryPolicy",
    "STALL_RC",
    "SupervisorConfig",
    "append_jsonl",
    "classify",
    "classify_exit",
    "corrupt_file",
    "heartbeat_record",
    "is_disk_full",
    "reclaim_disk",
    "supervise",
]
