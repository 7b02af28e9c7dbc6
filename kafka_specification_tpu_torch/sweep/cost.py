"""Log-linear frontier-growth cost model over the standing corpus.

BFS state counts over these bounded protocol configs grow roughly
geometrically in the config sizes (``cli report``'s per-run ETA fit
measures the same thing *within* one run's levels), so ``log(states)`` is
modeled as linear in per-constant log features::

    log(1 + states)  ~  w0 + sum_name w_name * log(1 + size(name))
                        + w_depth * log(1 + effective_depth_bound)

fit by ridge-regularized least squares (tiny lambda — the corpus can be
a handful of records and the normal equations must stay solvable) over
every completed check the system has banked: state-space cache entries
(the durable corpus), prior sweep manifests, and any
records a caller scrapes from BENCH/stats files.  Wall time is then
``states / throughput`` with throughput the corpus median states/sec —
the same flat-throughput assumption ``cli report``'s ETA has always
made, now in ONE place (:func:`flat_time_estimate`) so the two
prediction paths cannot drift.

Honesty limits: the fit extrapolates geometric growth
from small configs — a config that crosses a structural cliff (a new
action becoming enabled, a product mix) can be off by orders of
magnitude, which is exactly why every completed point records its
prediction-vs-actual residual in the sweep manifest and the model
re-fits over those residuals on the next sweep
(:meth:`CostModel.recalibrated`).  Predictions ORDER the portfolio
(cheap-first packing, expensive-solo) — they never gate correctness.

Torch-free (numpy only).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

#: ridge regularizer: keeps the normal equations solvable on tiny or
#: collinear corpora without visibly biasing a well-determined fit
_RIDGE = 1e-3

#: fallback throughput when the corpus has no timed records at all
#: (1-core CPU venue floor; any real record replaces it)
_DEFAULT_STATES_PER_SEC = 5_000.0

#: feature cap for unbounded depth: log-features need a finite value
#: for "no bound"; 64 exceeds every corpus diameter observed so far
_UNBOUNDED_DEPTH = 64


def flat_time_estimate(states: Optional[float],
                       states_per_sec: Optional[float]) -> Optional[float]:
    """THE flat-throughput wall estimate (seconds, 1 decimal): used by
    the per-run ETA in ``cli report`` (obs/report.eta) and by the sweep
    cost model's per-point wall predictions, so the two prediction
    paths share one formula by construction."""
    if states is None or not states_per_sec or states_per_sec <= 0:
        return None
    return round(float(states) / float(states_per_sec), 1)


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------


def _size(value) -> Optional[float]:
    """Numeric 'size' of one CONSTANT value: ints count themselves,
    model-value sets count their cardinality, other strings don't
    feature."""
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, (list, tuple)):
        return float(len(value))
    return None


def features_from(constants, max_depth=None, max_states=None) -> dict:
    """name -> log1p(size) feature map for one config.  ``constants``
    is a dict or the canonical ((name, value), ...) tuple form (the
    state-cache key / manifest form)."""
    items = constants.items() if isinstance(constants, dict) else constants
    out: dict = {}
    for name, value in items:
        s = _size(value)
        if s is not None:
            out[f"c:{name}"] = math.log1p(max(0.0, s))
    depth = _UNBOUNDED_DEPTH if max_depth is None else int(max_depth)
    out["b:max_depth"] = math.log1p(max(0, depth))
    if max_states is not None:
        out["b:max_states"] = math.log1p(max(0, int(max_states)))
    return out


# --------------------------------------------------------------------------
# corpus
# --------------------------------------------------------------------------


def corpus_records(state_cache_root: Optional[str] = None,
                   manifests: tuple = (),
                   extra: tuple = ()) -> list:
    """Training records from the standing corpus.  Each record::

        {"features": {...}, "states": int, "seconds": float|None,
         "source": "state-cache"|"sweep-manifest"|...}

    - ``state_cache_root``: every verified-enough entry of the
      persistent state-space cache (service/state_cache.iter_corpus —
      light validation only; a bad entry is skipped, never fatal).
    - ``manifests``: prior ``kspec-sweep/1`` manifest paths — completed
      points carry actuals, which is how the model self-recalibrates
      across sweeps.
    - ``extra``: pre-built record dicts (BENCH scrapes, tests).
    """
    records: list = []
    if state_cache_root:
        from ..service.state_cache import iter_corpus

        for entry in iter_corpus(state_cache_root):
            v = entry.get("verdict") or {}
            states = v.get("distinct_states")
            if states is None or v.get("violation") is not None:
                continue  # a violating run's count stops at the violation
            key = entry.get("key") or {}
            records.append({
                "features": features_from(
                    [tuple(kv) for kv in key.get("constants", [])],
                    max_depth=entry.get("max_depth"),
                    max_states=entry.get("max_states"),
                ),
                "states": int(states),
                "seconds": v.get("seconds"),
                "source": "state-cache",
            })
    for path in manifests:
        try:
            with open(path) as fh:
                man = json.load(fh)
        except (OSError, ValueError):
            continue
        for row in (man.get("points") or {}).values():
            v = row.get("verdict") or {}
            states = v.get("distinct_states")
            if row.get("status") != "done" or states is None:
                continue
            if v.get("violation") is not None:
                continue
            records.append({
                "features": features_from(
                    dict(row.get("constants") or {}),
                    max_depth=row.get("max_depth"),
                    max_states=row.get("max_states"),
                ),
                "states": int(states),
                "seconds": (row.get("actual") or {}).get("seconds"),
                "source": "sweep-manifest",
            })
    records.extend(extra)
    return records


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@dataclass
class CostModel:
    names: list = field(default_factory=list)  # feature names, fit order
    weights: list = field(default_factory=list)
    intercept: float = 0.0
    states_per_sec: float = _DEFAULT_STATES_PER_SEC
    n_records: int = 0
    residual_shift: float = 0.0  # log-space recalibration offset

    # --- fitting ----------------------------------------------------------
    @classmethod
    def fit(cls, records: list) -> "CostModel":
        """Ridge least squares of log1p(states) on the union feature
        set.  An empty corpus yields the honest null model: intercept 0,
        default throughput — predictions are then pure ordering noise
        and the first sweep's residuals immediately recalibrate it."""
        recs = [r for r in records if r.get("states") is not None]
        if not recs:
            return cls()
        names = sorted({n for r in recs for n in r["features"]})
        X = np.ones((len(recs), len(names) + 1))
        for i, r in enumerate(recs):
            for j, n in enumerate(names):
                X[i, 1 + j] = r["features"].get(n, 0.0)
        y = np.array([math.log1p(float(r["states"])) for r in recs])
        d = X.shape[1]
        reg = _RIDGE * np.eye(d)
        reg[0, 0] = 0.0  # never shrink the intercept
        w = np.linalg.solve(X.T @ X + reg, X.T @ y)
        rates = [
            r["states"] / r["seconds"]
            for r in recs
            if r.get("seconds") and r["seconds"] > 0
        ]
        return cls(
            names=list(names),
            weights=[float(v) for v in w[1:]],
            intercept=float(w[0]),
            states_per_sec=(
                float(np.median(rates)) if rates else _DEFAULT_STATES_PER_SEC
            ),
            n_records=len(recs),
        )

    # --- prediction -------------------------------------------------------
    def predict_log_states(self, features: dict) -> float:
        z = self.intercept + self.residual_shift
        for n, w in zip(self.names, self.weights):
            z += w * features.get(n, 0.0)
        return z

    def predict(self, features: dict) -> dict:
        """-> {"states": int, "seconds": float|None} for one feature map
        (see :func:`features_from`)."""
        states = max(1.0, math.expm1(self.predict_log_states(features)))
        return {
            "states": int(round(states)),
            "seconds": flat_time_estimate(states, self.states_per_sec),
        }

    def predict_point(self, point) -> dict:
        """Predict a :class:`~.lattice.LatticePoint` (features from its
        canonical key, so prediction and cache address agree on what the
        config IS)."""
        feats = features_from(
            point.key.constants,
            max_depth=point.max_depth,
            max_states=point.max_states,
        )
        return self.predict(feats)

    # --- recalibration ----------------------------------------------------
    def residual(self, features: dict, actual_states: int) -> float:
        """log-space prediction error for one completed point (positive
        = the point was BIGGER than predicted)."""
        return math.log1p(max(0, int(actual_states))) \
            - self.predict_log_states(features)

    def recalibrated(self, residuals: list) -> "CostModel":
        """A copy shifted by the mean residual — the cheap cross-sweep
        self-recalibration (the full refit happens anyway next sweep,
        when the manifest joins the corpus)."""
        import dataclasses

        if not residuals:
            return self
        return dataclasses.replace(
            self,
            residual_shift=self.residual_shift
            + float(np.mean([float(r) for r in residuals])),
        )

    # --- (de)serialization (rides the sweep manifest) ---------------------
    def to_dict(self) -> dict:
        return {
            "names": list(self.names),
            "weights": list(self.weights),
            "intercept": self.intercept,
            "states_per_sec": round(self.states_per_sec, 1),
            "n_records": self.n_records,
            "residual_shift": self.residual_shift,
        }

    @classmethod
    def from_dict(cls, rec: dict) -> "CostModel":
        return cls(
            names=list(rec.get("names", [])),
            weights=[float(w) for w in rec.get("weights", [])],
            intercept=float(rec.get("intercept", 0.0)),
            states_per_sec=float(
                rec.get("states_per_sec", _DEFAULT_STATES_PER_SEC)
            ),
            n_records=int(rec.get("n_records", 0)),
            residual_shift=float(rec.get("residual_shift", 0.0)),
        )


def fit_from_corpus(state_cache_root: Optional[str] = None,
                    manifests: tuple = ()) -> CostModel:
    """The one-call front door the portfolio and CLI use."""
    if state_cache_root is None:
        state_cache_root = os.environ.get("KSPEC_STATE_CACHE_DIR")
    return CostModel.fit(
        corpus_records(state_cache_root=state_cache_root,
                       manifests=manifests)
    )
