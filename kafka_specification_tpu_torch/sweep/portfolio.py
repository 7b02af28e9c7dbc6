"""Portfolio scheduler: thousands of lattice points, one durable sweep.

The port's own copy of ``kafka_specification_tpu/sweep/portfolio.py``.
The portfolio turns an enumerated lattice into traffic for the serving
plane, under a cost-model-shaped policy:

- **skip before pay** — points whose shape carries vacuous-action
  findings are marked ``skipped`` (policy ``on_vacuous=skip``) or run
  LAST (``defer``) with the finding attached to the manifest row: the
  skip is typed, machine-readable, auditable — never silent coverage
  loss.
- **cheap points batch** — predicted-cheap points are submitted
  cheapest-first and contiguously per schema shape, so one daemon drain
  claims them together and the scheduler coalesces them into
  service/batch.py groups (width-capped by the daemon's
  ``max_group``).
- **expensive points run solo** — a point predicted past
  ``solo_threshold_states`` is stamped ``solo`` at submit
  (queue.submit(solo=True)): one huge member must not drag a shared
  exploration out to ITS bounds envelope, and solo runs publish the
  full seedable state-cache artifact.
- **the cache makes repeats incremental** — points are keyed exactly
  like the state-space cache, so a repeat sweep O(verify)-hits every
  completed point and a deeper-bound sweep boundary-seeds; the verdict
  record's ``cache`` stamp is harvested into the manifest row.

Durability (``kspec-sweep/1``).  The manifest — ``sweep.json`` in the
sweep directory, like the router's ``router.json`` — is promoted with
the same tmp-write + atomic-replace idiom every other durable artifact
uses; it tracks every point's status (``pending`` → ``submitted`` →
``done`` | ``skipped`` | ``error``), predicted and actual cost, the
prediction residual, verdict subset and cache stamp.  Job ids are
DETERMINISTIC per (sweep nonce, point id), so a crash-resumed sweep
re-attaches to in-flight jobs and re-submits ONLY points whose job the
queue has never seen — each point runs exactly once per sweep.

Torch-free: the portfolio is a client of the queue/router, never of the
engine (planning's vacuity pass aside, see ``lattice.py``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from .. import durable_io as _dio
from ..obs import fleettrace
from ..obs.atomicio import atomic_write_json
from .cost import CostModel, features_from, fit_from_corpus
from .lattice import LatticeSpec, annotate_vacuous, enumerate_points

SWEEP_SCHEMA = "kspec-sweep/1"

#: manifest re-promote cadence while the scheduler loop runs (every
#: harvest also promotes; this bounds staleness on quiet stretches)
_PROMOTE_EVERY_S = 5.0

#: verdict subset a manifest row retains (the full record stays in the
#: service results/ dir, addressed by the row's job_id)
_VERDICT_KEEP = ("model", "distinct_states", "diameter", "violation",
                 "exit_code", "seconds", "states_per_sec")


@dataclass
class SweepConfig:
    sweep_dir: str
    service_dir: Optional[str] = None  # queue dispatch (exactly one of
    router_dir: Optional[str] = None   # service_dir/router_dir is set)
    tenant: str = "sweep"
    max_inflight: int = 64
    #: predicted distinct-states at/past which a point submits solo
    solo_threshold_states: int = 200_000
    wait_timeout_s: float = 900.0
    poll_s: float = 0.05
    state_cache_dir: Optional[str] = None  # cost-model corpus root
    prior_manifests: tuple = ()  # extra corpora for the fit
    #: optional callable() invoked whenever the wait loop is idle —
    #: tests and the single-process bench drive an in-process daemon's
    #: drain_once() here instead of needing a live `cli serve`
    drive: Optional[object] = None


class Dispatcher:
    """One submit/status/result surface over queue or router."""

    def __init__(self, cfg: SweepConfig):
        if bool(cfg.service_dir) == bool(cfg.router_dir):
            raise ValueError("exactly one of service_dir/router_dir")
        if cfg.router_dir:
            from ..service.router import Router

            self.backend = Router(cfg.router_dir)
        else:
            from ..service.queue import JobQueue

            self.backend = JobQueue(cfg.service_dir)
        self.tenant = cfg.tenant

    def submit(self, point, job_id: str, solo: bool) -> dict:
        return self.backend.submit(
            point.cfg_text,
            point.module,
            tenant=self.tenant,
            kernel_source=point.kernel_source,
            max_depth=point.max_depth,
            max_states=point.max_states,
            job_id=job_id,
            solo=solo,
        )

    def status(self, job_id: str) -> dict:
        return self.backend.status(job_id)

    def result(self, job_id: str) -> Optional[dict]:
        return self.backend.result(job_id)

    def max_pending_cap(self) -> Optional[int]:
        """The tenant's admission cap (tenants.json), when budgeted —
        the portfolio throttles BELOW it so sweep traffic never trips
        the submit-side admission control other tenants rely on."""
        try:
            from ..resilience.resources import (
                budget_for_tenant,
                load_tenant_budgets,
            )

            root = getattr(self.backend, "dir", None)
            if root is None:  # router: per-host tenants.json; skip
                return None
            budgets = load_tenant_budgets(
                os.path.join(root, "tenants.json")
            )
            b = budget_for_tenant(budgets, self.tenant)
            return getattr(b, "max_pending", None) if b else None
        except Exception:  # noqa: BLE001 — a cap probe must not fail a sweep
            return None


# --------------------------------------------------------------------------
# manifest
# --------------------------------------------------------------------------


@dataclass
class Manifest:
    path: str
    rec: dict

    @classmethod
    def open_or_create(cls, sweep_dir: str, lattice: LatticeSpec):
        path = os.path.join(sweep_dir, "sweep.json")
        # startup-janitor parity (crashcheck `sweep` scenario): a
        # promote killed mid-tmp-write leaves a nonce'd `.tmp` next to
        # sweep.json; the dir is shared with a possibly-live sweeper, so
        # the sweep is grace-aged like the queue's
        _dio.sweep_tmp(sweep_dir, min_age_s=_dio.TMP_SWEEP_GRACE_S)
        if os.path.isfile(path):
            with open(path) as fh:
                rec = json.load(fh)
            if rec.get("schema") != SWEEP_SCHEMA:
                raise ValueError(
                    f"{path} is not a {SWEEP_SCHEMA} manifest"
                )
            return cls(path, rec)
        os.makedirs(sweep_dir, exist_ok=True)
        rec = {
            "schema": SWEEP_SCHEMA,
            # the nonce makes this SWEEP INSTANCE's job ids unique: a
            # crash-resume reloads it (same ids — exactly-once), while a
            # fresh repeat sweep mints new ids and genuinely re-runs
            # every point through the daemon (where the state cache, not
            # stale results, makes it cheap)
            "sweep_id": f"{lattice.name}-{os.urandom(4).hex()}",
            "name": lattice.name,
            "created_unix": round(time.time(), 3),
            "lattice": lattice.record(),
            "cost_model": None,
            "points": {},
        }
        return cls(path, rec)

    def promote(self) -> None:
        self.rec["updated_unix"] = round(time.time(), 3)
        # a crash-resumed sweeper can race a wedged-but-alive
        # predecessor to this one final path: privatise the tmp so
        # neither promotes the other's
        # half-written bytes
        atomic_write_json(
            self.path, self.rec,
            tmp_nonce=f"{os.getpid():x}-{os.urandom(4).hex()}",
        )

    def row(self, point_id: str) -> Optional[dict]:
        return self.rec["points"].get(point_id)

    def ensure_row(self, point) -> dict:
        row = self.rec["points"].get(point.point_id)
        if row is None:
            row = dict(point.record())
            row["constants"] = {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in point.key.constants
            }
            row["status"] = "pending"
            row["job_id"] = None
            self.rec["points"][point.point_id] = row
        return row

    def counts(self) -> dict:
        out = {"pending": 0, "submitted": 0, "done": 0, "skipped": 0,
               "error": 0, "hit": 0, "seeded": 0}
        for row in self.rec["points"].values():
            out[row.get("status", "pending")] = (
                out.get(row.get("status", "pending"), 0) + 1
            )
            cache = row.get("cache") or {}
            if cache.get("state_cache") == "hit":
                out["hit"] += 1
            elif cache.get("state_cache") == "seed":
                out["seeded"] += 1
        return out


def job_id_for(sweep_id: str, point_id: str) -> str:
    """Deterministic per (sweep instance, point): the crash-resume key."""
    return f"sw-{sweep_id}-{point_id.replace(':', '-')}"


# --------------------------------------------------------------------------
# the scheduler loop
# --------------------------------------------------------------------------


def _harvest(row: dict, rec: dict, model: CostModel) -> None:
    """Fold one verdict record into its manifest row: verdict subset,
    actual cost, cache stamp, and the prediction residual the next
    sweep's fit learns from."""
    verdict = {k: rec.get(k) for k in _VERDICT_KEEP}
    row["verdict"] = verdict
    row["status"] = (
        "error" if rec.get("exit_code") not in (0, 1) else "done"
    )
    row["cache"] = rec.get("cache")
    states = rec.get("distinct_states")
    row["actual"] = {
        "states": states,
        "seconds": rec.get("seconds"),
    }
    if states is not None and rec.get("violation") is None:
        feats = features_from(
            dict(row.get("constants") or {}),
            max_depth=row.get("max_depth"),
            max_states=row.get("max_states"),
        )
        row["residual"] = round(model.residual(feats, int(states)), 4)


def plan_sweep(lattice: LatticeSpec, cfg: SweepConfig) -> dict:
    """Enumerate + annotate + predict, no dispatch: what `cli sweep
    plan` renders.  -> {points, model, skipped, deferred, runnable}."""
    points = annotate_vacuous(enumerate_points(lattice))
    model = fit_from_corpus(
        state_cache_root=_cache_root(cfg),
        manifests=tuple(cfg.prior_manifests),
    )
    skipped, deferred, runnable = [], [], []
    for p in points:
        if p.vacuous and lattice.on_vacuous == "skip":
            skipped.append(p)
        elif p.vacuous and lattice.on_vacuous == "defer":
            deferred.append(p)
        else:
            runnable.append(p)
    predictions = {p.point_id: model.predict_point(p) for p in points}
    return {
        "points": points,
        "model": model,
        "predictions": predictions,
        "skipped": skipped,
        "deferred": deferred,
        "runnable": runnable,
    }


def _cache_root(cfg: SweepConfig) -> Optional[str]:
    if cfg.state_cache_dir:
        return cfg.state_cache_dir
    if os.environ.get("KSPEC_STATE_CACHE_DIR"):
        return os.environ["KSPEC_STATE_CACHE_DIR"]
    if cfg.service_dir:
        return os.path.join(cfg.service_dir, "state-cache")
    return None


def run_sweep(lattice: LatticeSpec, cfg: SweepConfig,
              log=None) -> dict:
    """Run (or crash-resume) one sweep to completion.  Returns the final
    manifest record.  ``log`` is an optional callable(str) for progress
    lines (the CLI passes print)."""
    say = log or (lambda _s: None)
    dispatch = Dispatcher(cfg)
    plan = plan_sweep(lattice, cfg)
    model: CostModel = plan["model"]
    manifest = Manifest.open_or_create(cfg.sweep_dir, lattice)
    sweep_id = manifest.rec["sweep_id"]
    manifest.rec["cost_model"] = model.to_dict()

    # --- fold the plan into the manifest ---------------------------------
    for p in plan["skipped"]:
        row = manifest.ensure_row(p)
        if row["status"] == "pending":
            row["status"] = "skipped"
            row["skip"] = {"reason": "vacuous", "findings": p.vacuous}
    for p in plan["deferred"]:
        row = manifest.ensure_row(p)
        row.setdefault("skip", {"reason": "vacuous-deferred",
                                "findings": p.vacuous})
    # runnable + deferred all get predictions and (eventually) runs;
    # deferred points sort after every clean point
    to_run = []
    for rank, p in enumerate(plan["runnable"] + plan["deferred"]):
        row = manifest.ensure_row(p)
        pred = plan["predictions"][p.point_id]
        row["predicted"] = pred
        row["solo"] = bool(
            pred["states"] >= cfg.solo_threshold_states
        )
        if row["status"] in ("pending", "submitted"):
            to_run.append((p, row, rank >= len(plan["runnable"])))
    manifest.promote()

    # --- resume: re-attach to jobs the queue already knows ---------------
    outstanding: dict = {}  # job_id -> row
    fresh: list = []
    for p, row, deferred in to_run:
        jid = job_id_for(sweep_id, p.point_id)
        if row["status"] == "submitted":
            st = dispatch.status(jid)
            if st["state"] == "done" and st.get("result"):
                _harvest(row, st["result"], model)
                continue
            if st["state"] in ("pending", "claimed"):
                outstanding[jid] = row  # still in flight: just wait
                continue
            # unknown: the crash hit between manifest promote and queue
            # publish — submit is idempotent on the deterministic id
        fresh.append((p, row, deferred))

    # cheap-first within (clean, deferred): cheap points of one shape
    # land contiguously and coalesce into batched groups; expensive
    # points trail and run solo
    fresh.sort(key=lambda t: (t[2], t[1]["predicted"]["states"],
                              t[0].point_id))

    cap = cfg.max_inflight
    tenant_cap = dispatch.max_pending_cap()
    if tenant_cap:
        cap = max(1, min(cap, int(tenant_cap)))
    say(
        f"[sweep] {lattice.name}: {len(manifest.rec['points'])} points "
        f"({len(fresh)} to submit, {len(outstanding)} in flight, "
        f"cost model over {model.n_records} corpus records)"
    )

    # --- the loop: keep `cap` in flight, harvest as verdicts land --------
    t_promote = time.monotonic()
    deadline = time.monotonic() + cfg.wait_timeout_s
    idx = 0
    try:
        while fresh[idx:] or outstanding:
            while fresh[idx:] and len(outstanding) < cap:
                p, row, _d = fresh[idx]
                idx += 1
                jid = job_id_for(sweep_id, p.point_id)
                spec = dispatch.submit(p, jid, solo=bool(row.get("solo")))
                # portfolio membership is a trace annotation: `cli trace`
                # on any sweep job names its sweep without a side lookup
                fleettrace.emit_event(
                    dispatch.backend.dir, spec.get("trace"),
                    "sweep-member", job_id=jid, sweep_id=sweep_id,
                    point_id=p.point_id, solo=bool(row.get("solo")),
                    predicted_states=(row.get("predicted") or {}).get(
                        "states"
                    ),
                )
                row["status"] = "submitted"
                row["job_id"] = jid
                outstanding[jid] = row
            landed = []
            for jid, row in outstanding.items():
                rec = dispatch.result(jid)
                if rec is not None:
                    _harvest(row, rec, model)
                    landed.append(jid)
            for jid in landed:
                outstanding.pop(jid)
            if landed or time.monotonic() - t_promote > _PROMOTE_EVERY_S:
                manifest.promote()
                t_promote = time.monotonic()
            if not landed:
                if time.monotonic() >= deadline:
                    say(
                        f"[sweep] timeout with {len(outstanding)} points "
                        "in flight (resume with the same sweep dir)"
                    )
                    break
                if cfg.drive is not None:
                    cfg.drive()
                else:
                    time.sleep(cfg.poll_s)
            else:
                deadline = time.monotonic() + cfg.wait_timeout_s
    finally:
        # self-recalibration: the residuals this sweep measured shift
        # the model the NEXT resume/repeat loads from the manifest
        residuals = [
            row["residual"]
            for row in manifest.rec["points"].values()
            if row.get("residual") is not None
        ]
        manifest.rec["cost_model"] = model.recalibrated(
            residuals
        ).to_dict()
        manifest.promote()
    say(f"[sweep] {_counts_line(manifest)}")
    return manifest.rec


def _counts_line(manifest: Manifest) -> str:
    c = manifest.counts()
    return (
        f"done={c['done']} (hit={c['hit']} seeded={c['seeded']}) "
        f"skipped={c['skipped']} error={c['error']} "
        f"pending={c['pending'] + c['submitted']}"
    )


def load_manifest(sweep_dir: str) -> dict:
    path = os.path.join(sweep_dir, "sweep.json")
    with open(path) as fh:
        rec = json.load(fh)
    if rec.get("schema") != SWEEP_SCHEMA:
        raise ValueError(f"{path} is not a {SWEEP_SCHEMA} manifest")
    return rec
