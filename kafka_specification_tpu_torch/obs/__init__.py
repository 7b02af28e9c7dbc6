"""The run context and its telemetry: run manifests, span tracing,
metrics, run reports.

The port's own copy of ``kafka_specification_tpu/obs/``, kept under the
same module names, file names and record shapes, so the two packages'
run directories are interchangeable for ``cli report``:

- :class:`RunContext` (obs/runctx) — a run_id + run directory
  (``runs/<run_id>/``) holding a ``manifest.json`` (config, engine, git,
  knobs, lineage across resumes, terminal status) and the run's stats,
  spans and metrics;
- :class:`SpanTracer` (obs/tracer) — nested run_id-stamped spans to an
  append-only untearable JSONL, with optional ``torch.profiler`` windows
  attachable to a span kind via ``KSPEC_OBS_XPROF=<kind>:<lo>-<hi>``;
- :class:`MetricsRegistry` (obs/metrics) — counters/gauges/histograms
  exported as JSONL snapshots and an atomically-replaced Prometheus
  textfile;
- :func:`render_report` (obs/report) — ``cli report <run-dir>``: per-level
  throughput, action enablement, spill accounting, the event timeline,
  growth-rate ETA, and a stall verdict;
- :class:`RunObserver` (obs/observer) — the engine's shim: with only a
  ``stats_path`` it writes the per-level stream record for record as
  before; with a run context it additionally stamps, traces and
  aggregates.

Deep call sites in storage/ and resilience/ reach the active
tracer/registry through the module-level ``tracer.span/event`` and
``metrics.inc/set_gauge`` helpers, imported lazily at the call site to
keep the obs <-> resilience import graph acyclic.  The fleet traces
(``obs/fleettrace.py``) span hosts and jobs rather than one run.

Stdlib only at import: torch is imported only when a profiler window
starts.
"""

from .atomicio import atomic_write_json, atomic_write_text
from .metrics import MetricsRegistry
from .observer import RunObserver
from .report import render_report, report_data
from .runctx import RunContext, default_run_dir, new_run_id
from .tracer import SpanTracer, read_jsonl_tolerant

__all__ = [
    "MetricsRegistry",
    "RunContext",
    "RunObserver",
    "SpanTracer",
    "atomic_write_json",
    "atomic_write_text",
    "default_run_dir",
    "new_run_id",
    "read_jsonl_tolerant",
    "render_report",
    "report_data",
]
