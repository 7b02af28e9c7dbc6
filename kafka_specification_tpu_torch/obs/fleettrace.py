"""Fleet trace plane, emit side: one trace per job, from submit to verdict.

The port's own copy of the emit half of
``kafka_specification_tpu/obs/fleettrace.py``; its records equal the JAX
package's apart from ids and clocks.  The reassembly (``assemble``), the
renderers, ``top_data`` and the vocabulary lint come with the fleet verbs.

:func:`mint_trace` runs at ``JobQueue.submit`` and plants the context
inside the job spec file::

    spec["trace"] = {"trace_id": "tr-<job_id>",
                     "span_id": "<root span id>",
                     "anchor_unix": <submitted_unix>}

so it survives every hand-off of the spec (claim, requeue, batching).
Specs without a ``trace`` key no-op every stamp site: the emitters return
None on a missing context and never raise on it.

Every span or event is one JSON line in the per-run tracer's record shape,
in the heartbeat envelope (``ts``/``unix``), appended to
``<root>/traces/<job_id>.jsonl`` (``<root>`` a service directory) with one
``os.write`` on an ``O_APPEND`` descriptor, so concurrent writers
interleave whole lines.  Telemetry never takes a component down: a failed
write reads as False.

Torch-free (the queue imports it on the client side).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..resilience.heartbeat import heartbeat_record
from ..utils import clock as _clk

TRACES_DIR = "traces"

#: fleet span kinds (the ``span`` field of emitted records), one entry per
#: stamp site class, as registered in the JAX package
SPAN_KINDS = {
    "job-submit": "queue: spec published into pending/ (the trace root)",
    "route-place": "router: admission + health-aware host choice",
    "queue-claim": "queue: pending->claimed rename + lease write",
    "sched-group": "daemon: scheduler batched this job into a group",
    "svc-run": "daemon: batch/solo engine run (run_id links the child)",
    "cache-lookup": "daemon: state-cache consult (hit/seed/miss/fallback)",
    "cache-publish": "daemon: federated state-space cache publish",
    "verdict-publish": "daemon: atomic verdict write + claim retire",
}

#: fleet event kinds: annotations, not durations
EVENT_KINDS = {
    "route-reroute": "router: pending job moved off a dead host",
    "queue-requeue": "queue: orphaned claim taken over (crash adoption)",
    "sweep-member": "sweep: job submitted as a portfolio point",
}


def new_span_id() -> str:
    """Cross-host-unique without coordination (48 random bits)."""
    return os.urandom(6).hex()


def mint_trace(job_id: str, anchor_unix: float) -> dict:
    """The trace context planted in the spec at submit: the trace id derives
    from the job id, the anchor is the submit-time clock every stage is
    measured against."""
    return {
        "trace_id": f"tr-{job_id}",
        "span_id": new_span_id(),
        "anchor_unix": round(float(anchor_unix), 3),
    }


def trace_path(root: str, job_id: str) -> str:
    return os.path.join(root, TRACES_DIR, f"{job_id}.jsonl")


def now() -> float:
    """The fleet-trace clock: wall time plus any injected ``skew@host``
    offset (``resilience.faults.injected_skew_s``)."""
    from ..resilience.faults import injected_skew_s

    return _clk.now() + injected_skew_s()


def _identity(attrs: dict) -> dict:
    """The clock domain stamped on every record: this pid, and the host and
    daemon instance (from the environment, or popped from `attrs`)."""
    ident = {"pid": os.getpid()}
    host = os.environ.get("KSPEC_HOST_INSTANCE")
    if host is not None:
        ident["host"] = host
    inst = os.environ.get("KSPEC_DAEMON_INSTANCE")
    if inst is not None:
        ident["instance"] = inst
    for k in ("host", "instance"):
        if k in attrs:
            v = attrs.pop(k)
            if v is not None:
                ident[k] = str(v)
    return ident


def _append(path: str, rec: dict) -> bool:
    """One whole record in one O_APPEND write, the newline LEADING: a record
    appended after a predecessor's torn tail terminates that tail instead
    of gluing onto it.  OSError reads as False, never raises."""
    payload = ("\n" + json.dumps(rec)).encode()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        return True
    except OSError:
        return False


def emit_span(root: str, trace: Optional[dict], kind: str,
              t0: float, t1: float, *, job_id: str,
              parent_id: Optional[str] = None,
              span_id: Optional[str] = None, **attrs) -> Optional[str]:
    """Append one completed fleet span under ``root``; -> its span id, or
    None without a trace context (or when the write failed)."""
    if not isinstance(trace, dict) or "trace_id" not in trace:
        return None
    if kind not in SPAN_KINDS:
        raise ValueError(f"unregistered fleet span kind {kind!r} "
                         "(register it in obs.fleettrace.SPAN_KINDS)")
    sid = span_id or new_span_id()
    ident = _identity(attrs)
    rec = heartbeat_record(
        "span", t=now(), ph="E", span=kind, span_id=sid,
        parent_id=parent_id, t0=round(t0, 3),
        ms=round((t1 - t0) * 1e3, 1),
        trace_id=trace["trace_id"], job_id=job_id,
        anchor_unix=trace.get("anchor_unix"), **ident, **attrs,
    )
    return sid if _append(trace_path(root, job_id), rec) else None


def emit_event(root: str, trace: Optional[dict], kind: str, *,
               job_id: str, **attrs) -> bool:
    """Append one point annotation (a requeue) under ``root``; the same
    no-op contract as :func:`emit_span`."""
    if not isinstance(trace, dict) or "trace_id" not in trace:
        return False
    if kind not in EVENT_KINDS:
        raise ValueError(f"unregistered fleet event kind {kind!r} "
                         "(register it in obs.fleettrace.EVENT_KINDS)")
    ident = _identity(attrs)
    rec = heartbeat_record(
        "event", t=now(), event=kind,
        trace_id=trace["trace_id"], job_id=job_id,
        anchor_unix=trace.get("anchor_unix"), **ident, **attrs,
    )
    return _append(trace_path(root, job_id), rec)
