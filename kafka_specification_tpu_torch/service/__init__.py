"""Checking-as-a-service on one host: a warm serving daemon on the card.

The port's own copy of ``kafka_specification_tpu/service/`` (its one-host
half; the fleet, the router and the sweeps come later):

- :mod:`queue` — the durable on-disk job queue (an atomic-rename state
  machine, the JAX package's layout); the torch-FREE tenant side: ``cli
  submit`` writes a job spec, ``cli status`` / ``cli result`` read
  verdicts, and clients never pay the torch import.
- :mod:`daemon` — ``cli serve``: one process imports torch once, holds
  built models in a shape-keyed cache and drains the queue on the card
  under per-tenant resource budgets.
- :mod:`kernel_cache` — the model cache, keyed by schema shape (module,
  kernel source, constants, invariants).
- :mod:`scheduler` — the batching plan and per-tenant admission/budgets.
- :mod:`batch` — jobs sharing a schema shape advanced by ONE engine run,
  each member's verdict derived equal to a solo ``cli check``.
- :mod:`state_cache` — checked explorations as chain-verified artifacts:
  a repeat check is a cache hit with no engine run, a deeper bound seeds
  from the cached boundary.
- :mod:`verdict` — the shared ``kspec-verdict/1`` record.

Importing this package is torch-free; only :mod:`daemon`, :mod:`batch`
and :mod:`kernel_cache`'s model builds touch torch, and only when the
daemon runs.
"""

from .queue import JOB_SCHEMA, JobQueue, new_job_id
from .verdict import (
    VERDICT_SCHEMA,
    error_verdict,
    render_verdict,
    verdict_exit_code,
    verdict_from_result,
)

__all__ = [
    "JOB_SCHEMA",
    "JobQueue",
    "VERDICT_SCHEMA",
    "error_verdict",
    "new_job_id",
    "render_verdict",
    "verdict_exit_code",
    "verdict_from_result",
]
