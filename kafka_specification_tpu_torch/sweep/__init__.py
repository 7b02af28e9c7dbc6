"""Coverage sweep subsystem: the config lattice as a scheduled portfolio.

The port's own copy of ``kafka_specification_tpu/sweep/``: its lattice,
manifest (``kspec-sweep/1``) and frontier records equal the JAX
package's.  The reference corpus is only ever checked at a handful of
hand-picked CONSTANTS, but the protocol's interesting behavior lives on a
*lattice* of configs (brokers x log sizes x MaxId x bounds x product
mixes).  This package turns the serving plane (``service/``) into a
standing workload generator over that lattice:

- :mod:`.lattice` — declarative lattice spec (``kspec-sweep-lattice/1``)
  enumerated into canonical points keyed COMPATIBLY with the state-space
  cache's key schema (service/state_cache.CacheKey), with points whose
  distinguishing actions are statically vacuous under their CONSTANTS
  (``kspec analyze`` findings) skipped/deferred *before* any exploration
  is paid for.
- :mod:`.cost` — a log-linear frontier-growth cost model fit from the
  standing corpus (state-cache entries + banked BENCH/stats records +
  prior sweep manifests), predicting states and wall per point, with
  prediction-vs-actual residuals recorded on every completed point so
  the model self-recalibrates across sweeps.  Also the ONE shared
  flat-throughput time estimator ``cli report``'s ETA delegates to.
- :mod:`.portfolio` — schedules the points under per-tenant budgets
  through the existing queue or router: predicted-cheap points packed
  so the daemon's group planner coalesces them into batched
  runs, predicted-expensive points marked solo; a durable sweep
  manifest (``kspec-sweep/1``, atomic-promote, crash-resumable) tracks
  every point's verdict + cost.
- :mod:`.bisect` — from lattice verdicts, the minimal-violating-config
  frontier per invariant (Pareto-minimal over axis coordinates),
  refined by actually running the claimed-minimal points' lower
  neighbors until the frontier is witnessed, not guessed.

The package is torch-free (like the service clients and the router):
dispatch, bisection and reporting run on operator boxes that never pay
the torch import.  The one exception is planning's vacuity pass
(:func:`.lattice.vacuous_findings`), which runs the port's interval
analyser on CPU tensors and never initialises CUDA.  The only engine
work a sweep causes happens inside serving daemons.
"""

from .bisect import (  # noqa: F401
    bisect_line,
    frontier_from_manifest,
    refine_frontier,
)
from .cost import (  # noqa: F401
    CostModel,
    corpus_records,
    fit_from_corpus,
    flat_time_estimate,
)
from .lattice import (  # noqa: F401
    LATTICE_SCHEMA,
    Axis,
    LatticePoint,
    LatticeSpec,
    enumerate_points,
    load_lattice,
    vacuous_findings,
)
from .portfolio import (  # noqa: F401
    SWEEP_SCHEMA,
    Dispatcher,
    Manifest,
    SweepConfig,
    job_id_for,
    load_manifest,
    plan_sweep,
    run_sweep,
)
