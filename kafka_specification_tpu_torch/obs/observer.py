"""RunObserver: the engines' one window into the obs subsystem.

The port's own copy of ``kafka_specification_tpu/obs/observer.py``.
``engine/bfs.py::check`` and ``parallel/sharded.py::check_sharded``
(``engine="sharded"``) route their per-level stats through it:

- with only ``stats_path``, the emitted records are **identical** to the
  stream the engine wrote before it had a run context — same envelope,
  same fields, same order, no run_id;
- with a :class:`~.runctx.RunContext`, the same records are additionally
  run_id-stamped, routed to the run directory's ``stats.jsonl`` (unless
  ``stats_path`` points elsewhere), folded into the metrics registry
  (states/sec, duplicate ratio, per-shard imbalance, wall-share
  counters), snapshotted to
  ``metrics.jsonl`` + ``metrics.prom`` at most every 5 s and at the end,
  and bracketed by level spans.

Constructing an observer also (de)activates the module-global tracer and
metrics registry: a ``run=None`` engine call always *clears* them, so a
crashed traced run can never leak spans into a later untraced run in the
same process.

Stdlib only.
"""

from __future__ import annotations

import time
from typing import Optional

from ..resilience.heartbeat import append_jsonl, heartbeat_record
from .metrics import set_registry
from .tracer import set_tracer


# metrics export cadence: toy models run thousands of millisecond-scale
# levels, and metrics.prom is an fsync'd whole-file rewrite — snapshot at
# most this often (scrapers poll in tens of seconds; finish() always
# writes the terminal snapshot)
_SNAPSHOT_MIN_INTERVAL_S = 5.0


class RunObserver:
    def __init__(self, run=None, stats_path: Optional[str] = None,
                 engine: str = "bfs"):
        self.run = run
        self.engine = engine
        self._last_snapshot = 0.0
        # the stats stream: exactly where the caller pointed it; the run
        # directory's stats.jsonl is the default only when a run is active
        self.stats_path = stats_path or (run.stats_path if run else None)
        self.active = run is not None
        # stats collection is on iff anyone consumes it (pre-obs semantics:
        # `collect_stats = stats_path is not None`)
        self.collect = self.stats_path is not None or self.active
        if run is not None:
            run.activate()
        else:
            set_tracer(None)
            set_registry(None)

    # --- configuration stamping -------------------------------------------
    def config(self, **fields) -> None:
        if self.run is not None:
            self.run.record_config(engine=self.engine, **fields)

    # --- per-level emission -----------------------------------------------
    def level_begin(self, depth: int, frontier: int) -> None:
        """Begin marker for the level span (crash forensics: a 'B' with no
        matching 'E' pins the level the run died in)."""
        if self.run is not None:
            self.run.tracer.begin("level", depth=depth, frontier=frontier)

    def level(self, **fields) -> dict:
        """Build + route the per-level heartbeat record.

        `fields` is the engine's record payload, in its order.  Returns
        the record (the engine also keeps it in result.stats['levels'])."""
        if self.run is not None:
            rec = heartbeat_record("level", run_id=self.run.run_id, **fields)
        else:
            rec = heartbeat_record("level", **fields)
        if self.stats_path is not None:
            append_jsonl(self.stats_path, rec)
        if self.run is not None:
            # span t0 back-computed from the record's own wall time (the
            # engine times levels with perf_counter, a different clock)
            t0 = time.time() - fields.get("level_ms", 0.0) / 1e3
            self.run.tracer.end(
                "level", t0, depth=fields.get("depth"),
                new=fields.get("new"), total=fields.get("total"),
            )
            self._fold_metrics(fields)
            now = time.time()
            if now - self._last_snapshot >= _SNAPSHOT_MIN_INTERVAL_S:
                self._last_snapshot = now
                self.run.snapshot_metrics()
        return rec

    def _fold_metrics(self, f: dict) -> None:
        m = self.run.metrics
        new = f.get("new", 0)
        dup = f.get("duplicates", 0)
        en = f.get("enabled_candidates", 0)
        lvl_ms = f.get("level_ms", 0.0)
        m.inc("kspec_levels_total")
        m.inc("kspec_states_total", new)
        m.inc("kspec_duplicates_total", dup)
        m.inc("kspec_enabled_candidates_total", en)
        m.set_gauge("kspec_depth", f.get("depth", 0))
        m.set_gauge("kspec_frontier", f.get("frontier", 0))
        m.set_gauge("kspec_states_distinct", f.get("total", 0))
        m.set_gauge("kspec_duplicate_ratio",
                    round(dup / en, 4) if en else 0.0)
        m.set_gauge("kspec_states_per_sec",
                    round(new / (lvl_ms / 1e3), 1) if lvl_ms else 0.0)
        m.observe("kspec_level_ms", lvl_ms)
        # host-vs-step wall share (single-device engine records both)
        if "step_ms" in f:
            m.inc("kspec_step_ms_total", f["step_ms"])
        if "host_ms" in f:
            m.inc("kspec_host_ms_total", f["host_ms"])
        # per-shard exchange balance (the sharded engine)
        shard_new = f.get("shard_new")
        if shard_new:
            for d, v in enumerate(shard_new):
                m.set_gauge("kspec_shard_new", v, shard=d)
            mean = sum(shard_new) / len(shard_new)
            m.set_gauge(
                "kspec_shard_imbalance",
                round(max(shard_new) / mean, 3) if mean else 0.0,
            )
        for key, name in (
            ("shard_frontier", "kspec_shard_frontier"),
            ("shard_duplicates", "kspec_shard_duplicates"),
        ):
            vals = f.get(key)
            if vals:
                for d, v in enumerate(vals):
                    m.set_gauge(name, v, shard=d)

    # --- sub-level spans ---------------------------------------------------
    def chunk_span(self, kind: str, seconds: float, **attrs) -> None:
        """Record a completed chunk-phase span (step / host-assembly /
        host-probe) from the engine's own duration timer — no-op without
        a run."""
        if self.run is not None:
            t1 = time.time()
            self.run.tracer.emit_span(kind, t1 - seconds, t1, **attrs)

    # --- terminal ----------------------------------------------------------
    def abort(self, status: str, **detail) -> None:
        """Terminal manifest update for a non-CheckResult ending — the
        typed RESOURCE_EXHAUSTED and INTEGRITY_VIOLATION exits: the
        manifest's status is what `cli report`'s verdict keys on, and the
        detail (reason / depth / states so far) lands under result."""
        if self.run is not None:
            self.run.finish(status, **detail)

    def finish(self, result) -> None:
        """Fold the terminal CheckResult into metrics + manifest."""
        if self.run is None:
            return
        m = self.run.metrics
        s = result.stats or {}
        m.inc("kspec_transient_retries_total", s.get("transient_retries", 0))
        m.set_gauge("kspec_degradations", len(s.get("degradations", ())))
        # the sharded engine's tier reports one record a shard (None where
        # another process owns it): one gauge a shard, labeled
        spill = s.get("spill")
        spills = spill if isinstance(spill, list) else [spill]
        for d, sp in enumerate(spills):
            if not sp:
                continue
            labels = {"shard": d} if isinstance(spill, list) else {}
            m.set_gauge("kspec_spill_runs", sp.get("runs", 0), **labels)
            m.set_gauge("kspec_spill_hot_fps", sp.get("hot", 0), **labels)
            m.set_gauge("kspec_spill_disk_fps", sp.get("disk", 0), **labels)
            m.set_gauge("kspec_spill_spills", sp.get("spills", 0), **labels)
            m.set_gauge("kspec_spill_merges", sp.get("merges", 0), **labels)
            bt = sp.get("bloom_totals")
            if bt:
                m.inc("kspec_bloom_maybe_total", bt["bloom_maybe"])
                m.inc(
                    "kspec_bloom_filtered_total",
                    bt["probes"] - bt["bloom_maybe"],
                )
                m.inc("kspec_bloom_hits_total", bt["hits"])
        status = "violation" if result.violation is not None else "complete"
        summary = dict(
            model=result.model,
            distinct_states=result.total,
            diameter=result.diameter,
            seconds=round(result.seconds, 3),
            states_per_sec=round(result.states_per_sec, 1),
        )
        if result.violation is not None:
            summary["violation"] = {
                "invariant": result.violation.invariant,
                "depth": result.violation.depth,
                "trace_len": len(result.violation.trace),
            }
        self.run.finish(status, **summary)

    def close(self) -> None:
        if self.run is not None:
            self.run.deactivate()
