"""Fleet trace plane, emit side: one trace per job, from submit to verdict.

The port's own copy of ``kafka_specification_tpu/obs/fleettrace.py``; its
records, its reassembly and its renderings (``cli trace``, ``top``,
``fleet-report``) equal the JAX package's apart from ids and clocks.

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
write reads as False.  Reassembly reads through
:func:`obs.tracer.read_jsonl_tolerant`, so a torn line never breaks
``cli trace``.

Layout: ``<root>/traces/<job_id>.jsonl`` where ``<root>`` is a host's
service dir (queue and daemon stamps) or the router dir (placement and
re-route stamps).  One job's trace is the tolerant union of that file
across every root.

Skew normalization: hosts' clocks disagree (``skew@host`` injects real
offsets).  Every record carries the submit-time ``anchor_unix`` and its
clock domain (``host``, ``pid``); :func:`assemble` pulls each domain
forward so none of its records precede the anchor, and clamps every
derived stage at zero, so ``cli trace`` never renders a negative stage.

Vocabulary: :data:`SPAN_KINDS`/:data:`EVENT_KINDS` register the fleet's,
:data:`ENGINE_SPAN_KINDS`/:data:`ENGINE_EVENT_KINDS` the per-run
tracer's; :func:`lint_trace_vocabulary` (``cli analyze``'s
``trace-vocab`` target) scans the package for literal kind call sites and
fails on anything unregistered or undocumented.

Torch-free (the queue imports it on the client side).
"""

from __future__ import annotations

import json
import os
import re
from contextlib import contextmanager
from typing import Optional

from .. import durable_io as _dio
from ..resilience.heartbeat import heartbeat_record
from ..utils import clock as _clk
from .tracer import read_jsonl_tolerant

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


#: per-run engine tracer vocabulary (obs/tracer.py emitters) — the other
#: half of the registry the lint holds against docs/observability.md.
ENGINE_SPAN_KINDS = {
    "level", "compile", "step", "shadow", "host-assembly", "host-probe",
    "exchange", "exchange-level", "spill-run-write", "spill-merge",
    "checkpoint-write", "checkpoint-verify",
}
ENGINE_EVENT_KINDS = {
    "pipeline-fallback", "xprof-start", "xprof-stop",
    "retry", "chunk-degrade", "compile-fallback", "checkpoint-fallback",
    "integrity-violation", "elastic-reshard",
}

#: typed latency decomposition, in waterfall order.  docs/observability.md
#: documents how each is derived from the span tree.
STAGES = ("queue-wait", "placement", "claim", "group-wait",
          "compile", "explore", "verify", "publish")


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
        _dio.note_append(path, payload)
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


@contextmanager
def fleet_span(root: str, trace: Optional[dict], kind: str, *,
               job_id: str, **attrs):
    """Context-manager form of :func:`emit_span` for sites that bracket
    real work.  Yields a dict the body may fill with extra attrs; the
    span is emitted on NORMAL exit only — an exception propagates with
    nothing written, exactly like a killed process (partial traces show
    what the dead incarnation finished, never what it was mid-way
    through)."""
    t0 = now()
    extra: dict = {}
    yield extra
    emit_span(root, trace, kind, t0, now(), job_id=job_id,
              **{**attrs, **extra})


# --- reassembly ------------------------------------------------------------

def load_trace(roots, job_id: str) -> list:
    """Tolerant union of one job's trace file across every root (host
    service dirs + the router dir).  Missing files — a host that never
    touched the job, or one whose disk died — contribute nothing."""
    recs = []
    for root in roots:
        recs.extend(read_jsonl_tolerant(trace_path(root, job_id)))
    return recs


def _domain(rec: dict):
    return (rec.get("host"), rec.get("pid"))


def assemble(records: list, job_id: Optional[str] = None) -> dict:
    """Normalize one job's records into a skew-corrected span tree plus
    the typed stage decomposition.

    Normalization: per clock domain (host, pid), shift every timestamp
    forward by ``max(0, anchor - earliest_t0)`` — a domain whose clock
    ran behind the submitter's would otherwise place work before the
    submit instant, which is physically impossible.  Domains running
    ahead are left alone (their stamps stay ordered and non-negative);
    every derived stage duration is additionally clamped at zero.
    Output timestamps are ``t0n``/``t1n``/``tn``: seconds relative to
    the anchor."""
    spans = [dict(r) for r in records
             if r.get("kind") == "span" and r.get("trace_id")]
    events = [dict(r) for r in records
              if r.get("kind") == "event" and r.get("trace_id")]
    anchors = [r["anchor_unix"] for r in spans + events
               if isinstance(r.get("anchor_unix"), (int, float))]
    anchor = min(anchors) if anchors else None
    trace_id = next(
        (r["trace_id"] for r in spans + events), None
    )
    if job_id is None:
        job_id = next((r.get("job_id") for r in spans + events), None)

    shifts: dict = {}
    if anchor is not None:
        firsts: dict = {}
        for r in spans:
            t0 = r.get("t0")
            if isinstance(t0, (int, float)):
                d = _domain(r)
                firsts[d] = min(firsts.get(d, t0), t0)
        for r in events:
            t = r.get("unix")
            if isinstance(t, (int, float)):
                d = _domain(r)
                firsts[d] = min(firsts.get(d, t), t)
        shifts = {d: max(0.0, anchor - first)
                  for d, first in firsts.items()}

    for r in spans:
        shift = shifts.get(_domain(r), 0.0)
        t0 = r.get("t0")
        if isinstance(t0, (int, float)) and anchor is not None:
            r["t0n"] = round(t0 + shift - anchor, 3)
            r["t1n"] = round(r["t0n"] + max(0.0, r.get("ms", 0.0)) / 1e3, 3)
    for r in events:
        shift = shifts.get(_domain(r), 0.0)
        t = r.get("unix")
        if isinstance(t, (int, float)) and anchor is not None:
            r["tn"] = round(max(0.0, t + shift - anchor), 3)

    spans.sort(key=lambda r: (r.get("t0n", 0.0), r.get("span", "")))
    events.sort(key=lambda r: (r.get("tn", 0.0), r.get("event", "")))

    ends = [r["t1n"] for r in spans if "t1n" in r]
    ends += [r["tn"] for r in events if "tn" in r]
    hosts = sorted({str(r["host"]) for r in spans + events
                    if r.get("host") is not None})
    return {
        "trace_id": trace_id,
        "job_id": job_id,
        "anchor_unix": anchor,
        "spans": spans,
        "events": events,
        "hosts": hosts,
        "shifts": {"{}:{}".format(*d): round(s, 3)
                   for d, s in shifts.items() if s},
        "duration_ms": round(max(ends) * 1e3, 1) if ends else None,
        "stages": stage_decomposition(spans),
        "complete": any(r.get("span") == "verdict-publish" for r in spans),
    }


def stage_decomposition(spans: list) -> dict:
    """The typed latency decomposition (ms per stage, None = stage never
    happened).  Durations come from normalized timestamps and are
    clamped at zero — see :func:`assemble`."""
    by_kind: dict = {}
    for r in spans:
        if "t0n" in r:
            by_kind.setdefault(r.get("span"), []).append(r)

    def total_ms(kind):
        rs = by_kind.get(kind)
        if not rs:
            return None
        return round(sum(max(0.0, r.get("ms", 0.0)) for r in rs), 1)

    stages = dict.fromkeys(STAGES)
    claims = by_kind.get("queue-claim", [])
    runs = by_kind.get("svc-run", [])
    lookups = by_kind.get("cache-lookup", [])
    if claims:
        stages["queue-wait"] = round(
            max(0.0, min(r["t0n"] for r in claims)) * 1e3, 1
        )
    stages["placement"] = total_ms("route-place")
    stages["claim"] = total_ms("queue-claim")
    if runs and claims:
        last_claim_end = max(r["t1n"] for r in claims)
        stages["group-wait"] = round(
            max(0.0, min(r["t0n"] for r in runs) - last_claim_end) * 1e3, 1
        )
    if runs:
        compile_ms = sum(
            float(r.get("compile_ms") or 0.0) for r in runs
        )
        stages["compile"] = round(compile_ms, 1)
        stages["explore"] = round(
            max(0.0, sum(max(0.0, r.get("ms", 0.0)) for r in runs)
                - compile_ms), 1
        )
    if lookups:
        stages["verify"] = total_ms("cache-lookup")
    pub = [total_ms("verdict-publish"), total_ms("cache-publish")]
    if any(v is not None for v in pub):
        stages["publish"] = round(sum(v or 0.0 for v in pub), 1)
    return stages


# --- rendering -------------------------------------------------------------

_BAR_WIDTH = 28


def render_trace(data: dict) -> str:
    """The cross-host waterfall: one line per span (bar scaled over the
    trace duration), annotations interleaved at their instant, stage
    decomposition at the foot."""
    if not data.get("spans") and not data.get("events"):
        return f"trace {data.get('trace_id') or '?'}: no records found"
    total = max(data.get("duration_ms") or 0.0, 1e-6)
    head = (
        f"Trace {data['trace_id']} (job {data['job_id']}): "
        f"{len(data['spans'])} spans, {len(data['events'])} annotations, "
        f"{total:.0f}ms"
    )
    if data["hosts"]:
        head += ", hosts " + ",".join(data["hosts"])
    if not data.get("complete"):
        head += "  [incomplete: no verdict-publish span]"
    out = [head]
    if data.get("shifts"):
        out.append(
            "  skew-normalized: "
            + ", ".join(f"domain {d} pulled +{s:.3f}s"
                        for d, s in sorted(data["shifts"].items()))
        )
    rows = [("span", r.get("t0n", 0.0), r) for r in data["spans"]]
    rows += [("event", r.get("tn", 0.0), r) for r in data["events"]]
    rows.sort(key=lambda x: x[1])
    for what, t, r in rows:
        off = f"+{t * 1e3:8.1f}ms"
        if what == "event":
            detail = " ".join(
                f"{k}={r[k]}" for k in ("from_host", "to_host", "from_pid",
                                        "sweep_id", "reason", "why")
                if r.get(k) is not None
            )
            out.append(f"  {off} ~ {r['event']:<16} [annotation] {detail}")
            continue
        ms = max(0.0, r.get("ms", 0.0))
        lead = int(_BAR_WIDTH * (t * 1e3) / total)
        width = max(1, int(round(_BAR_WIDTH * ms / total)))
        bar = " " * min(lead, _BAR_WIDTH - 1) + "#" * min(
            width, _BAR_WIDTH - min(lead, _BAR_WIDTH - 1)
        )
        who = "host" + str(r["host"]) if r.get("host") is not None else "-"
        detail = " ".join(
            f"{k}={r[k]}" for k in ("run_id", "outcome", "group_size",
                                    "states", "verdict")
            if r.get(k) is not None
        )
        out.append(
            f"  {off} {r['span']:<16} |{bar:<{_BAR_WIDTH}}| "
            f"{ms:8.1f}ms {who:<7} {detail}".rstrip()
        )
    stages = data.get("stages") or {}
    shown = [(s, stages[s]) for s in STAGES if stages.get(s) is not None]
    if shown:
        out.append(
            "  stages: " + " | ".join(f"{s} {v:.1f}ms" for s, v in shown)
        )
    return "\n".join(out)


# --- fleet report ----------------------------------------------------------

def _pctl(values, q: float):
    if not values:
        return None
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def list_trace_jobs(roots) -> list:
    """Every job id with a trace file under any root, sorted."""
    jobs = set()
    for root in roots:
        try:
            names = os.listdir(os.path.join(root, TRACES_DIR))
        except OSError:
            continue
        jobs.update(
            n[: -len(".jsonl")] for n in names if n.endswith(".jsonl")
        )
    return sorted(jobs)


def fleet_report_data(roots, exemplars: int = 5) -> dict:
    """Aggregate every trace under ``roots`` into the SLO evidence
    artifact: per-stage p50/p95 over completed traces, cache hit ratio,
    chaos annotation tally, and the slowest-trace exemplars with their
    full decomposition."""
    roots = list(dict.fromkeys(roots))
    traces = []
    for job_id in list_trace_jobs(roots):
        recs = load_trace(roots, job_id)
        if recs:
            traces.append(assemble(recs, job_id=job_id))
    complete = [t for t in traces if t["complete"]]
    stage_values: dict = {s: [] for s in STAGES}
    for t in complete:
        for s, v in (t["stages"] or {}).items():
            if v is not None:
                stage_values[s].append(v)
    lookups = {"hit": 0, "seed": 0, "miss": 0, "fallback": 0}
    annotations: dict = {}
    for t in traces:
        for r in t["spans"]:
            if r.get("span") == "cache-lookup":
                outcome = str(r.get("outcome"))
                if outcome in lookups:
                    lookups[outcome] += 1
        for r in t["events"]:
            k = r["event"]
            annotations[k] = annotations.get(k, 0) + 1
    n_lookups = sum(lookups.values())
    durations = [t["duration_ms"] for t in complete
                 if t["duration_ms"] is not None]
    slowest = sorted(
        (t for t in complete if t["duration_ms"] is not None),
        key=lambda t: -t["duration_ms"],
    )[:exemplars]
    return {
        "roots": roots,
        "traces": len(traces),
        "completed": len(complete),
        "stages": {
            s: {
                "n": len(vs),
                "p50_ms": _pctl(vs, 0.50),
                "p95_ms": _pctl(vs, 0.95),
            }
            for s, vs in stage_values.items() if vs
        },
        "duration": {
            "n": len(durations),
            "p50_ms": _pctl(durations, 0.50),
            "p95_ms": _pctl(durations, 0.95),
        },
        "cache": {
            "lookups": n_lookups,
            **lookups,
            "hit_ratio": (
                round(lookups["hit"] / n_lookups, 3) if n_lookups else None
            ),
        },
        "annotations": annotations,
        "slowest": [
            {
                "job_id": t["job_id"],
                "duration_ms": t["duration_ms"],
                "hosts": t["hosts"],
                "stages": t["stages"],
                "annotations": [r["event"] for r in t["events"]],
            }
            for t in slowest
        ],
    }


def render_fleet_report(data: dict) -> str:
    out = [
        f"Fleet report over {len(data['roots'])} root(s): "
        f"{data['traces']} traces, {data['completed']} completed"
    ]
    if data["stages"]:
        out.append("  stage            n      p50        p95")
        for s in STAGES:
            row = data["stages"].get(s)
            if row:
                out.append(
                    f"  {s:<14} {row['n']:>4} {row['p50_ms']:>8.1f}ms "
                    f"{row['p95_ms']:>8.1f}ms"
                )
        d = data["duration"]
        if d["n"]:
            out.append(
                f"  {'end-to-end':<14} {d['n']:>4} {d['p50_ms']:>8.1f}ms "
                f"{d['p95_ms']:>8.1f}ms"
            )
    c = data["cache"]
    out.append(
        f"  cache: {c['lookups']} lookups — {c['hit']} hit / "
        f"{c['seed']} seed / {c['miss']} miss / {c['fallback']} fallback"
        + (f" (hit ratio {c['hit_ratio']:.1%})"
           if c["hit_ratio"] is not None else "")
    )
    if data["annotations"]:
        out.append(
            "  chaos annotations: " + ", ".join(
                f"{k}={v}" for k, v in sorted(data["annotations"].items())
            )
        )
    for t in data["slowest"]:
        stages = t["stages"] or {}
        top = sorted(
            ((s, v) for s, v in stages.items() if v),
            key=lambda x: -x[1],
        )[:3]
        out.append(
            f"  slowest {t['job_id']}: {t['duration_ms']:.0f}ms "
            + " ".join(f"{s}={v:.0f}ms" for s, v in top)
            + (" [" + ",".join(t["annotations"]) + "]"
               if t["annotations"] else "")
        )
    return "\n".join(out)


# --- live fleet view (`cli top`) ------------------------------------------

def _parse_prom_hists(path: str) -> dict:
    """Histogram series from one metrics*.prom export:
    ``{name: {"buckets": {le: cum}, "sum": float, "count": int}}`` with
    labels stripped (the rollup aggregates across daemons)."""
    out: dict = {}
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError:
        return out

    def slot(base):
        return out.setdefault(
            base, {"buckets": {}, "sum": 0.0, "count": 0}
        )

    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        try:
            key, val = ln.rsplit(" ", 1)
            value = float(val)
        except ValueError:
            continue
        base, _, labels = key.partition("{")
        if base.endswith("_bucket"):
            m = re.search(r'le="([^"]+)"', labels)
            if m:
                b = slot(base[: -len("_bucket")])["buckets"]
                b[m.group(1)] = b.get(m.group(1), 0.0) + value
        elif base.endswith("_sum"):
            slot(base[: -len("_sum")])["sum"] += value
        elif base.endswith("_count"):
            slot(base[: -len("_count")])["count"] += int(value)
    return out


def hist_pctl(hist: dict, q: float):
    """Percentile estimate from cumulative buckets: the smallest upper
    bound whose cumulative count covers the quantile (the standard
    textfile-collector approximation; +Inf reads as the largest finite
    bound so a pathological tail still renders a number)."""
    count = hist.get("count", 0)
    if not count:
        return None
    target = q * count

    def bkey(le):
        return float("inf") if le == "+Inf" else float(le)

    finite = [bkey(le) for le in hist["buckets"] if le != "+Inf"]
    for le in sorted(hist["buckets"], key=bkey):
        if hist["buckets"][le] >= target:
            if le == "+Inf":
                return max(finite) if finite else None
            return float(le)
    return max(finite) if finite else None


def _count_jobs(root: str, sub: str) -> int:
    """Queue depth from the on-disk layout (``<root>/queue/<state>``)."""
    try:
        return len([
            n for n in os.listdir(os.path.join(root, "queue", sub))
            if n.endswith(".json")
        ])
    except OSError:
        return 0


def _sweep_jobs(root: str) -> dict:
    """In-flight sweep membership by queue stage, via the deterministic
    ``sw-<sweep>-<point>`` job-id prefix (sweep/portfolio.job_id_for)."""
    out = {}
    for sub in ("pending", "claimed", "done"):
        try:
            names = os.listdir(os.path.join(root, "queue", sub))
        except OSError:
            names = []
        out[sub] = len([
            n for n in names
            if n.startswith("sw-") and n.endswith(".json")
        ])
    return out


def _daemon_rows(svc: str) -> list:
    """One row per heartbeat*.jsonl: last record's state + age."""
    rows = []
    try:
        names = sorted(
            n for n in os.listdir(svc)
            if n.startswith("heartbeat") and n.endswith(".jsonl")
        )
    except OSError:
        return rows
    wall = _clk.now()
    for name in names:
        recs = read_jsonl_tolerant(os.path.join(svc, name))
        last = recs[-1] if recs else {}
        unix = last.get("unix")
        rows.append({
            "file": name,
            "pid": last.get("pid"),
            "state": last.get("state") or last.get("event") or "?",
            "age_s": (
                round(max(0.0, wall - unix), 1)
                if isinstance(unix, (int, float)) else None
            ),
        })
    return rows


def top_data(service_dirs, router_dir: Optional[str] = None) -> dict:
    """One frame of the live fleet view, entirely from on-disk state:
    queue depths + daemon heartbeats per host, per-stage p50/p95 from
    the daemons' stage histograms, cache hit ratio from the counter
    rollup, and in-flight sweep progress from job-id prefixes."""
    from .report import host_metrics_rollup

    hosts = []
    if router_dir:
        from ..service.router import Router

        router = Router(router_dir)
        for i, h in enumerate(router.healths()):
            hosts.append({
                "host": i,
                "dir": router.queues[i].dir,
                "state": h["state"],
            })
    else:
        for i, root in enumerate(service_dirs):
            hosts.append({"host": i, "dir": root, "state": "-"})

    hist_total: dict = {}
    counters_total: dict = {}
    for h in hosts:
        root = h["dir"]
        svc = os.path.join(root, "service")
        h["pending"] = _count_jobs(root, "pending")
        h["claimed"] = _count_jobs(root, "claimed")
        h["done"] = _count_jobs(root, "done")
        h["daemons"] = _daemon_rows(svc)
        h["sweep"] = _sweep_jobs(root)
        for key, value in host_metrics_rollup(svc).items():
            base = key.partition("{")[0]
            counters_total[base] = counters_total.get(base, 0.0) + value
        try:
            proms = sorted(
                n for n in os.listdir(svc)
                if n.startswith("metrics") and n.endswith(".prom")
            )
        except OSError:
            proms = []
        for name in proms:
            for base, hist in _parse_prom_hists(
                os.path.join(svc, name)
            ).items():
                agg = hist_total.setdefault(
                    base, {"buckets": {}, "sum": 0.0, "count": 0}
                )
                for le, c in hist["buckets"].items():
                    agg["buckets"][le] = agg["buckets"].get(le, 0.0) + c
                agg["sum"] += hist["sum"]
                agg["count"] += hist["count"]

    prefix = "kspec_svc_stage_"
    stages = {}
    for base, hist in hist_total.items():
        if base.startswith(prefix) and base.endswith("_ms"):
            stage = base[len(prefix): -len("_ms")].replace("_", "-")
            stages[stage] = {
                "n": hist["count"],
                "p50_ms": hist_pctl(hist, 0.50),
                "p95_ms": hist_pctl(hist, 0.95),
            }
    hits = counters_total.get("kspec_svc_state_cache_hits_total", 0.0)
    misses = counters_total.get("kspec_svc_state_cache_misses_total", 0.0)
    seeds = counters_total.get("kspec_svc_state_cache_seeds_total", 0.0)
    looked = hits + misses + seeds
    sweep = {
        sub: sum(h["sweep"][sub] for h in hosts)
        for sub in ("pending", "claimed", "done")
    }
    return {
        "router": router_dir,
        "hosts": hosts,
        "stages": stages,
        "cache": {
            "hits": hits,
            "hit_ratio": round(hits / looked, 3) if looked else None,
        },
        "sweep": sweep,
    }


def render_top(data: dict) -> str:
    out = [
        "kspec top — " + (
            f"router {data['router']}" if data["router"]
            else f"{len(data['hosts'])} host(s)"
        )
    ]
    out.append("  host  state   pending  claimed  done   daemons")
    for h in data["hosts"]:
        ds = " ".join(
            "{}{}".format(
                d["state"],
                f"@{d['age_s']}s" if d["age_s"] is not None else "",
            )
            for d in h["daemons"]
        ) or "-"
        out.append(
            f"  {h['host']:<5} {h['state']:<7} {h['pending']:>7}  "
            f"{h['claimed']:>7}  {h['done']:>4}   {ds}"
        )
    if data["stages"]:
        parts = []
        for s in STAGES:
            row = data["stages"].get(s)
            if row and row["p50_ms"] is not None:
                parts.append(
                    f"{s} p50={row['p50_ms']:.0f}/p95={row['p95_ms']:.0f}ms"
                )
        if parts:
            out.append("  stages: " + " | ".join(parts))
    c = data["cache"]
    out.append(
        "  cache: "
        + (f"{c['hit_ratio']:.1%} hit ratio ({c['hits']:.0f} hits)"
           if c["hit_ratio"] is not None else "no lookups yet")
    )
    sw = data["sweep"]
    total = sum(sw.values())
    if total:
        out.append(
            f"  sweep: {sw['done']}/{total} done "
            f"({sw['pending']} pending, {sw['claimed']} in flight)"
        )
    return "\n".join(out)


# --- vocabulary lint -------------------------------------------------------

# literal kind call sites.  Engine tracer calls put the kind FIRST
# (span("level", ...), chunk_span("step", ...)); fleet emitters put it
# THIRD (emit_span(root, trace, "queue-claim", ...)).  Dynamic sites
# (emit_span(kind, ...) with a variable) are invisible by design — their
# literals live at the callers, which ARE scanned.
_LINT_PATTERNS = (
    (re.compile(
        r'\b(?:span|begin|chunk_span|emit_span)\(\s*"([a-z0-9-]+)"'
    ), "span", "engine"),
    (re.compile(r'\bevent\(\s*"([a-z0-9-]+)"'), "event", "engine"),
    (re.compile(
        r'\b(?:emit_span|fleet_span)\(\s*[^,"\n]+,\s*[^,"\n]+,'
        r'\s*"([a-z0-9-]+)"'
    ), "span", "fleet"),
    (re.compile(
        r'\bemit_event\(\s*[^,"\n]+,\s*[^,"\n]+,\s*"([a-z0-9-]+)"'
    ), "event", "fleet"),
)

_DOCSTRING_RE = re.compile(r'""".*?"""|\'\'\'.*?\'\'\'', re.S)

_REGISTRIES = {
    ("span", "engine"): ENGINE_SPAN_KINDS,
    ("event", "engine"): ENGINE_EVENT_KINDS,
    ("span", "fleet"): SPAN_KINDS,
    ("event", "fleet"): EVENT_KINDS,
}


def lint_trace_vocabulary(package_root: Optional[str] = None,
                          docs_path: Optional[str] = None) -> list:
    """Static registry lint: every literal span/event kind emitted by
    the package must be registered above, and every registered kind must
    appear in docs/observability.md.  Returns a list of
    ``{path, line, kind, problem}`` findings (empty = clean); wired into
    ``cli analyze`` and pinned by a tier-1 test so the documented trace
    vocabulary cannot drift from what the code emits."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))
    if docs_path is None:
        docs_path = os.path.join(
            os.path.dirname(package_root), "docs", "observability.md"
        )
    findings = []
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            try:
                with open(path) as fh:
                    src = fh.read()
            except OSError:
                continue
            # docstrings carry example calls; only real code sites count
            scrubbed = _DOCSTRING_RE.sub(
                lambda m: "\n" * m.group(0).count("\n"), src
            )
            for pattern, what, plane in _LINT_PATTERNS:
                for m in pattern.finditer(scrubbed):
                    kind = m.group(1)
                    if kind not in _REGISTRIES[(what, plane)]:
                        findings.append({
                            "path": os.path.relpath(
                                path, os.path.dirname(package_root)
                            ),
                            "line": scrubbed[: m.start()].count("\n") + 1,
                            "kind": kind,
                            "problem": (
                                f"unregistered {plane} {what} kind "
                                f"(obs.fleettrace registries)"
                            ),
                        })
    try:
        with open(docs_path) as fh:
            docs = fh.read()
    except OSError:
        docs = None
    if docs is not None:
        documented = set(re.findall(r"`([a-z0-9-]+)`", docs))
        for registry in _REGISTRIES.values():
            for kind in sorted(registry):
                if kind not in documented:
                    findings.append({
                        "path": os.path.relpath(
                            docs_path, os.path.dirname(package_root)
                        ),
                        "line": 0,
                        "kind": kind,
                        "problem": "registered kind missing from docs",
                    })
    return findings
