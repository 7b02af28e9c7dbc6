"""RunContext: one run_id, one directory, one manifest for a whole run.

The port's own copy of ``kafka_specification_tpu/obs/runctx.py``, with
the same run id format, file names and manifest keys, so ``cli report`` of
either package renders the other's run directory.  Every ``cli check``
gets a run directory (``--run-dir``, default ``runs/<run_id>/`` under the
current directory or ``$KSPEC_RUNS_ROOT``):

    runs/<run_id>/
      manifest.json    config, engine, git describe, knobs, lineage, status
      stats.jsonl      the engine's per-level heartbeat stream (unless
                       --stats points it elsewhere)
      spans.jsonl      nested spans + point events (obs/tracer)
      metrics.jsonl    metric snapshots (obs/metrics)
      metrics.prom     Prometheus textfile export (atomic, scrapable)
      events.jsonl     supervisor events (`cli check --resilient`,
                       scripts/torch_resilient_run.py)
      logs/            per-attempt child logs of a supervised run
      spill/           disk-tier default when --mem-budget is set
      xprof/           torch.profiler windows (KSPEC_OBS_XPROF)

The manifest is written atomically at open (status "running"), updated
with a lineage entry every time an existing run directory is reopened (a
resumed run keeps its run_id: the run_id is the correlation key across
attempts), and finalized by ``finish`` with the terminal status + result
summary.  A manifest stuck at "running" whose heartbeat has gone stale is
exactly what ``cli report``'s stall verdict keys on.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

from ..resilience.heartbeat import heartbeat_record
from .atomicio import atomic_write_json
from .metrics import MetricsRegistry, set_registry
from .tracer import SpanTracer, set_tracer

MANIFEST = "manifest.json"


def new_run_id() -> str:
    """Sortable, collision-resistant without coordination:
    <utc-stamp>-<pid>-<4 hex>."""
    return "{}-{}-{}".format(
        time.strftime("%Y%m%dT%H%M%S", time.gmtime()),
        os.getpid(),
        os.urandom(2).hex(),
    )


def default_run_dir(run_id: str) -> str:
    root = os.environ.get("KSPEC_RUNS_ROOT", "runs")
    return os.path.join(root, run_id)


_GIT_DESCRIBE_CACHE: dict = {}


def git_describe(cwd: Optional[str] = None) -> Optional[str]:
    # memoized per (process, cwd): the checkout cannot change under a
    # live process, and a `git describe` costs tens of milliseconds
    key = cwd or os.path.dirname(os.path.abspath(__file__))
    if key in _GIT_DESCRIBE_CACHE:
        return _GIT_DESCRIBE_CACHE[key]
    try:
        p = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=key,
            capture_output=True,
            text=True,
            timeout=10,
        )
        out = p.stdout.strip() or None if p.returncode == 0 else None
    except Exception:
        # transient subprocess failure (timeout under load, fork error):
        # do NOT memoize — one bad moment must not stamp git=None on
        # every later run of the process.  A clean nonzero exit ("not a
        # git repository") IS deterministic and cached below.
        return None
    _GIT_DESCRIBE_CACHE[key] = out
    return out


class RunContext:
    def __init__(self, run_dir: Optional[str] = None,
                 run_id: Optional[str] = None, durable: bool = True):
        """Open (creating if needed) a run directory.

        A fresh directory gets a new run_id + manifest; an existing one is
        *resumed*: its manifest's run_id is adopted and a lineage entry is
        appended (checkpoint lineage across resumes).  Every manifest
        write is atomic, and fsync'd unless durable=False: the serving
        daemon's per-job run directories, whose durable record is the
        queue's verdict file."""
        self.durable = durable
        existing = None
        if run_dir is not None and os.path.isfile(
            os.path.join(run_dir, MANIFEST)
        ):
            try:
                with open(os.path.join(run_dir, MANIFEST)) as fh:
                    existing = json.load(fh)
            except ValueError:
                existing = None  # torn manifest: treat as fresh
        if existing is not None and existing.get("run_id"):
            run_id = existing["run_id"]
        self.run_id = run_id or new_run_id()
        self.dir = os.path.normpath(run_dir or default_run_dir(self.run_id))
        os.makedirs(self.dir, exist_ok=True)
        self.manifest_path = os.path.join(self.dir, MANIFEST)
        self.stats_path = os.path.join(self.dir, "stats.jsonl")
        self.spans_path = os.path.join(self.dir, "spans.jsonl")
        self.metrics_jsonl = os.path.join(self.dir, "metrics.jsonl")
        self.metrics_prom = os.path.join(self.dir, "metrics.prom")
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self.log_dir = os.path.join(self.dir, "logs")
        self.spill_dir = os.path.join(self.dir, "spill")

        self.tracer = SpanTracer(self.spans_path, self.run_id)
        self.metrics = MetricsRegistry(self.run_id)

        if existing is not None:
            self.manifest = existing
            self.manifest.setdefault("lineage", []).append(
                {"event": "reopen", "pid": os.getpid(),
                 **_ts_fields()}
            )
            self.manifest["status"] = "running"
            self.manifest["pid"] = os.getpid()
        else:
            self.manifest = {
                "run_id": self.run_id,
                "status": "running",
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "cwd": os.getcwd(),
                "git": git_describe(),
                "lineage": [
                    {"event": "open", "pid": os.getpid(), **_ts_fields()}
                ],
                **_ts_fields("created", "created_unix"),
            }
        self.write_manifest()

    # --- manifest ---------------------------------------------------------
    def write_manifest(self) -> None:
        atomic_write_json(self.manifest_path, self.manifest, fsync=self.durable)

    def update_manifest(self, **fields) -> None:
        self.manifest.update(fields)
        self.write_manifest()

    def record_config(self, **fields) -> None:
        """Stamp run configuration (module, engine, knobs...) — keys land
        under manifest['config'], merged across calls (a resumed run may
        re-record identical config; new keys win)."""
        cfg = self.manifest.setdefault("config", {})
        cfg.update({k: v for k, v in fields.items() if v is not None})
        self.write_manifest()

    # --- activation (global tracer/registry for deep call sites) ----------
    def activate(self) -> None:
        set_tracer(self.tracer)
        set_registry(self.metrics)

    def deactivate(self) -> None:
        self.tracer.xprof_force_stop()  # windows must flush even when a
        set_tracer(None)                # verdict cut the level loop early
        set_registry(None)
        self.tracer.close()

    # --- exports ----------------------------------------------------------
    def snapshot_metrics(self) -> None:
        self.metrics.write_jsonl(self.metrics_jsonl)
        self.metrics.write_prom(self.metrics_prom)

    def finish(self, status: str, **summary) -> None:
        """Terminal manifest update + final metric snapshot."""
        self.manifest["status"] = status
        self.manifest.setdefault("lineage", []).append(
            {"event": "finish", "status": status, **_ts_fields()}
        )
        if summary:
            self.manifest["result"] = summary
        self.write_manifest()
        self.snapshot_metrics()


def _ts_fields(ts_key: str = "ts", unix_key: str = "unix") -> dict:
    rec = heartbeat_record("x")
    return {ts_key: rec["ts"], unix_key: rec["unix"]}
