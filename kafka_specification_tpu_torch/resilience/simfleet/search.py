"""Seed sweep, schedule shrinking, and the ``kspec-simfleet/1`` repro.

A sweep runs generation-mode seeds and, for each violating seed, shrinks
the recorded schedule to a minimal one that still trips the same oracle:
ddmin-style chunk removal over the event list, then single-event
removal, then a delay-zeroing pass (a step that only matters for its
time advance survives with ``dt`` intact; one that doesn't loses it).
Replay of a subset works because the kernel skips entries that no
longer apply — dropping a ``kill`` simply makes the later ``restart``
a no-op, not an error.

The minimal schedule is persisted as a ``kspec-simfleet/1`` file:

    {"schema": "kspec-simfleet/1",
     "seed": <int>,                    # feeds the retry-jitter RNG
     "config": {...SimConfig...},
     "violation": {"oracle": ..., "job": ..., "detail": ...},
     "schedule": [{"a","h","x","dt"}, ...],
     "events_digest": <sha256 of the shrunk run's surface>,
     "shrunk_from": <original step count>}

``replay_repro`` re-runs the schedule and reports whether the recorded
oracle fires again AND the determinism surface digest matches — a repro
that stops reproducing (the bug got fixed, or the tree drifted) is
reported stale, never silently green.
"""

from __future__ import annotations

import json

from ... import durable_io as _dio
from .kernel import SimConfig, run_schedule, run_seed

REPRO_SCHEMA = "kspec-simfleet/1"

#: per-candidate replay budget during shrinking — ddmin on an 80-step
#: schedule stays well under a second per candidate, but a pathological
#: run record must not turn shrinking into the slow part of a sweep
MAX_SHRINK_RUNS = 400


def _violates(record: dict, oracle: str) -> bool:
    return any(v["oracle"] == oracle for v in record["violations"])


def shrink(schedule: list, config: SimConfig, seed: int,
           oracle: str) -> tuple:
    """-> (minimal schedule, its run record).  The predicate is "the
    same oracle still fires"; every candidate is a full deterministic
    replay."""
    runs = 0

    def trial(cand: list):
        nonlocal runs
        if runs >= MAX_SHRINK_RUNS:
            return None
        runs += 1
        rec, _ = run_schedule(cand, config=config, seed=seed)
        return rec if _violates(rec, oracle) else None

    best = list(schedule)
    best_rec = trial(best)
    if best_rec is None:
        raise ValueError(
            f"schedule does not reproduce oracle {oracle!r}")
    # ddmin: drop halves, then quarters, ... of the event list
    chunk = max(1, len(best) // 2)
    while chunk >= 1:
        i = 0
        progressed = False
        while i < len(best) and len(best) > 1:
            cand = best[:i] + best[i + chunk:]
            rec = trial(cand)
            if rec is not None:
                best, best_rec = cand, rec
                progressed = True
            else:
                i += chunk
        if chunk == 1 and not progressed:
            break
        chunk = max(1, chunk // 2) if chunk > 1 else 0
    # delay-zeroing: keep an event, drop its time advance
    for i in range(len(best)):
        if best[i].get("dt"):
            cand = [dict(e) for e in best]
            cand[i]["dt"] = 0.0
            rec = trial(cand)
            if rec is not None:
                best, best_rec = cand, rec
    return best, best_rec


def save_repro(path: str, seed: int, config: SimConfig, violation: dict,
               schedule: list, record: dict, shrunk_from: int) -> dict:
    repro = {
        "schema": REPRO_SCHEMA,
        "seed": seed,
        "config": config.to_dict(),
        "violation": {k: violation[k]
                      for k in ("oracle", "job", "detail")},
        "schedule": schedule,
        "events_digest": record["digest"],
        "shrunk_from": shrunk_from,
    }
    _dio.write_text(path, json.dumps(repro, indent=1, sort_keys=True)
                    + "\n", fsync=True)
    return repro


def load_repro(path: str) -> dict:
    with open(path) as fh:
        repro = json.load(fh)
    if repro.get("schema") != REPRO_SCHEMA:
        raise ValueError(
            f"not a {REPRO_SCHEMA} file: {repro.get('schema')!r}")
    return repro


def replay_repro(repro: dict, keep_root: bool = False) -> dict:
    """-> {"reproduced": bool, "digest_match": bool, "record": ...,
    "kernel": SimKernel|None}.  ``keep_root`` leaves the simulated
    host/router dirs on disk (the ``--trace`` waterfall reads them)."""
    cfg = SimConfig.from_dict(repro["config"])
    rec, kernel = run_schedule(repro["schedule"], config=cfg,
                               seed=int(repro.get("seed") or 0),
                               keep=keep_root)
    return {
        "reproduced": _violates(rec, repro["violation"]["oracle"]),
        "digest_match": rec["digest"] == repro.get("events_digest"),
        "record": rec,
        "kernel": kernel if keep_root else None,
    }


def _pair_coverage(record: dict) -> set:
    """Adjacent event-type pairs the run exercised — the cheap schedule-
    shape signal the coverage-guided sweep steers on."""
    acts = [e["a"] for e in record["events"] if not e["out"].get("skipped")]
    return {(a, b) for a, b in zip(acts, acts[1:])}


def sweep_seeds(seeds, config: SimConfig = None, coverage: bool = False,
                max_extra: int = 0, progress=None) -> dict:
    """Run generation-mode seeds; -> summary with any violations (one
    entry per violating seed, carrying the full run record for
    shrinking).  ``coverage=True`` queues up to ``max_extra`` derived
    seeds (seed*1000+k) behind any seed whose run reached new adjacent
    event-type pairs — interleaving neighborhoods that discover new
    schedule shapes get searched harder."""
    config = config or SimConfig()
    seen_pairs: set = set()
    queue = list(seeds)
    extra_budget = max_extra if coverage else 0
    out = {"config": config.to_dict(), "runs": 0, "clean": 0,
           "violating": [], "pair_coverage": 0}
    while queue:
        seed = queue.pop(0)
        record = run_seed(seed, config=config)
        out["runs"] += 1
        if progress is not None:
            progress(seed, record)
        if record["violations"]:
            out["violating"].append({"seed": seed, "record": record})
        else:
            out["clean"] += 1
        if coverage:
            pairs = _pair_coverage(record)
            fresh = pairs - seen_pairs
            seen_pairs |= pairs
            if fresh and extra_budget > 0:
                derived = [seed * 1000 + k for k in (1, 2)]
                derived = derived[:extra_budget]
                extra_budget -= len(derived)
                queue.extend(derived)
    out["pair_coverage"] = len(seen_pairs)
    return out
