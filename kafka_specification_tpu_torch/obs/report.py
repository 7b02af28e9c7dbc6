"""`cli report <run-dir>`: render a run directory into a human summary.

The port's own copy of the single-run part of
``kafka_specification_tpu/obs/report.py``: the same sections, text and
``--json`` record, so either package's ``cli report`` renders either
package's run directory alike, and so do its router, sweep and
host-rollup reports (``router_report_data``, ``sweep_report_data``).

Works on any run directory — completed, still live, or crashed mid-level:
every input is optional and every JSONL stream is read torn-final-line
tolerantly (the only tear the O_APPEND writers can leave).  Never touches
the card.

Sections:
  header     run id / module / engine / status verdict
  levels     per-level table + states/sec sparkline (TLC's live coverage
             statistics, after the fact and correlated by run)
  actions    cumulative action-enablement histogram (TLC action coverage)
  spill      disk-tier accounting (runs/spills/merges/bloom gating)
  timeline   restarts, stall-kills, checkpoint fallbacks, retries,
             degradations — supervisor events + obs events, interleaved
  ETA        frontier growth-rate fit over the recent levels
  verdict    complete / violation / live / stalled / crashed — the stall
             rule is the supervisor's (no heartbeat growth past the stall
             timeout)
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

from .tracer import read_jsonl_tolerant

DEFAULT_STALL_TIMEOUT = 1800.0  # the supervisor's default
_SPARK = "▁▂▃▄▅▆▇█"
_EVENT_KINDS = (
    "retry",
    "compile-fallback",
    "chunk-degrade",
    "checkpoint-fallback",
    "elastic-reshard",
    "resource-pressure",
    "reclaim",
    "resource-exhausted",
    "integrity-violation",
    "pipeline-fallback",
    "xprof-start",
    "xprof-stop",
)


def load_run(run_dir: str) -> dict:
    """Collect everything a run directory holds, tolerating absences."""
    run_dir = os.path.normpath(run_dir)

    def maybe_json(name):
        p = os.path.join(run_dir, name)
        if os.path.isfile(p):
            try:
                with open(p) as fh:
                    return json.load(fh)
            except ValueError:
                return None  # torn manifest: the report still renders
        return None

    def jsonl(name):
        return read_jsonl_tolerant(os.path.join(run_dir, name))

    spans = jsonl("spans.jsonl")
    metrics = jsonl("metrics.jsonl")
    # per-process shard heartbeats (parallel/sharded.py writes one file
    # per process under <run-dir>/shards/): the only stream that tells a
    # multiprocess run's processes apart after the fact
    shard_streams = []
    shard_dir = os.path.join(run_dir, "shards")
    if os.path.isdir(shard_dir):
        for name in sorted(os.listdir(shard_dir)):
            if name.startswith("proc") and name.endswith(".jsonl"):
                recs = read_jsonl_tolerant(os.path.join(shard_dir, name))
                recs = [r for r in recs
                        if r.get("kind") == "shard-heartbeat"]
                if recs:
                    shard_streams.append(recs)
    return {
        "dir": run_dir,
        "manifest": maybe_json("manifest.json") or {},
        "levels": [r for r in jsonl("stats.jsonl") if r.get("kind") == "level"],
        "events": jsonl("events.jsonl"),
        "spans": [s for s in spans if s.get("kind") == "span"],
        "obs_events": [s for s in spans if s.get("kind") == "event"],
        "metrics": metrics[-1] if metrics else None,
        # full snapshot history: the resource-pressure timeline reads the
        # disk/RSS gauges ACROSS snapshots, not just the last one
        "metrics_history": metrics,
        "shard_heartbeats": shard_streams,
    }


def _pid_alive(pid) -> Optional[bool]:
    if not pid:
        return None
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except (OSError, ValueError):
        return None  # permission / foreign host: unknowable


def verdict(data: dict, now: Optional[float] = None) -> dict:
    """-> {status, detail}: the stall rule is the supervisor's (heartbeat
    growth within the stall timeout), so report and sentry agree."""
    man = data["manifest"]
    status = man.get("status")
    if status in ("complete", "violation", "error", "resource-exhausted",
                  "integrity-violation"):
        # resource-exhausted / integrity-violation are TERMINAL, not
        # crashes: the run exited typed (75 / 76); the detail says what
        # ran out or which integrity check tripped
        return {"status": status, "detail": man.get("result", {})}
    now = time.time() if now is None else now
    beats = [r.get("unix") for r in data["levels"] if r.get("unix")]
    beats += [r.get("unix") for r in data["spans"] if r.get("unix")]
    beats += [r.get("unix") for r in data["events"] if r.get("unix")]
    for stream in data.get("shard_heartbeats", ()):
        beats += [r.get("unix") for r in stream if r.get("unix")]
    last = max(beats) if beats else man.get("unix") or man.get("created_unix")
    age = (now - last) if last else None
    timeout = float(
        (man.get("config") or {}).get("stall_timeout") or DEFAULT_STALL_TIMEOUT
    )
    # a supervisor give-up is terminal ONLY for the current attempt chain:
    # reopening the run dir (a new `cli check --run-dir` on it) appends a
    # fresh open/reopen lineage entry, and give-ups older than that must
    # not shadow the live run
    last_open = max(
        (e.get("unix", 0) for e in man.get("lineage", ())
         if e.get("event") in ("open", "reopen")),
        default=0,
    )
    for ev in reversed(data["events"]):
        if ev.get("event") == "give-up" and ev.get("unix", 0) >= last_open:
            return {
                "status": "crashed",
                "detail": {"supervisor": "gave up", "last_heartbeat_age_s":
                           round(age, 1) if age is not None else None},
            }
    alive = _pid_alive(man.get("pid"))
    if alive is False:
        return {
            "status": "crashed",
            "detail": {
                "pid": man.get("pid"),
                "last_heartbeat_age_s": round(age, 1) if age else None,
            },
        }
    if age is not None and age > timeout:
        return {
            "status": "stalled",
            "detail": {
                "last_heartbeat_age_s": round(age, 1),
                "stall_timeout_s": timeout,
            },
        }
    return {
        "status": "live",
        "detail": {"last_heartbeat_age_s": round(age, 1) if age is not None
                   else None},
    }


def _shard_proc_summary(data: dict) -> list:
    """One row per process of a (multi)process sharded run, from its
    shard-heartbeat stream: pid, owned shards, last completed level."""
    procs = []
    for stream in data.get("shard_heartbeats", ()):
        last = stream[-1]
        procs.append({
            "proc": last.get("proc"),
            "pid": last.get("pid"),
            "shards": last.get("shards"),
            "last_depth": max(
                (r.get("depth") for r in stream
                 if r.get("depth") is not None),
                default=None,
            ),
            "last_unix": last.get("unix"),
            "alive": _pid_alive(last.get("pid")),
            "finished": any(r.get("event") == "finish" for r in stream),
        })
    return procs


def _died_shards(procs: list) -> list:
    """Which process(es) a died-mid-level verdict points at.

    Preference order: known-dead pids that never finished; else any
    unfinished process.  Among those, the one(s) that stopped a level
    behind the rest died first (a lockstep fleet cannot advance past a
    dead peer, so the laggard is the culprit); a level tie falls back to
    the stalest heartbeat."""
    cands = [p for p in procs if p["alive"] is False and not p["finished"]]
    if not cands:
        cands = [p for p in procs if not p["finished"]]
    if not cands:
        return []
    lo = min((p["last_depth"] or 0) for p in cands)
    behind = [p for p in cands if (p["last_depth"] or 0) == lo]
    if len(behind) < len(cands) or len(cands) == 1:
        return behind
    t = min((p["last_unix"] or 0) for p in cands)
    return [p for p in cands if (p["last_unix"] or 0) == t]


def eta(levels: list, window: int = 5) -> dict:
    """Frontier growth-rate fit: log-linear least squares on the per-level
    new-state counts over the last `window` levels.  A decaying frontier
    (ratio < 1) extrapolates the geometric tail into a finite remaining
    count and, via the recent throughput, a time estimate; a flat or
    growing frontier is honestly unbounded (BFS cannot know its horizon).
    """
    pts = [(r["depth"], r["new"]) for r in levels
           if r.get("new", 0) > 0 and "depth" in r]
    if len(pts) < 3:
        return {"status": "insufficient-data"}
    pts = pts[-window:]
    xs = [p[0] for p in pts]
    ys = [math.log(p[1]) for p in pts]
    n = len(pts)
    mx, my = sum(xs) / n, sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / max(denom, 1e-12)
    ratio = math.exp(slope)
    recent = levels[-window:]
    wall_ms = sum(r.get("level_ms", 0.0) for r in recent)
    new_sum = sum(r.get("new", 0) for r in recent)
    rate = new_sum / (wall_ms / 1e3) if wall_ms else None
    out = {"status": "fit", "growth_ratio": round(ratio, 3),
           "recent_states_per_sec": round(rate, 1) if rate else None}
    if ratio < 0.999:
        remaining = pts[-1][1] * ratio / (1.0 - ratio)
        out["est_remaining_states"] = int(remaining)
        # levels until the geometric tail drops below one new state
        out["est_remaining_levels"] = (
            max(1, int(math.ceil(-math.log(pts[-1][1]) / math.log(ratio))))
            if pts[-1][1] > 1
            else 1
        )
        if rate:
            from ..sweep.cost import flat_time_estimate

            out["eta_seconds"] = flat_time_estimate(remaining, rate)
    else:
        out["note"] = "frontier not yet decaying; ETA unbounded"
    return out


def _spark(vals: list) -> str:
    if not vals:
        return ""
    hi = max(vals) or 1
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int(v / hi * (len(_SPARK) - 1)))] for v in vals)


def _fmt_dur(s: Optional[float]) -> str:
    if s is None:
        return "?"
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.1f}m"
    return f"{s / 3600:.1f}h"


def report_data(run_dir: str, now: Optional[float] = None) -> dict:
    """The machine-readable report (cli report --json)."""
    data = load_run(run_dir)
    levels = data["levels"]
    man = data["manifest"]
    actions: dict = {}
    for r in levels:
        for name, c in (r.get("action_enablement") or {}).items():
            actions[name] = actions.get(name, 0) + int(c)
    # spill accounting: last metrics snapshot (finish-time gauges when the
    # run completed, live counters either way) + span aggregates
    snap = data["metrics"] or {}
    spill = {
        k: v
        for src in ("gauges", "counters")
        for k, v in snap.get(src, {}).items()
        if k.startswith(("kspec_spill_", "kspec_bloom_"))
    }
    span_agg: dict = {}
    for s in data["spans"]:
        if s.get("ph") != "E":
            continue
        k = s.get("span")
        a = span_agg.setdefault(k, {"count": 0, "ms": 0.0})
        a["count"] += 1
        a["ms"] += s.get("ms", 0.0)
    timeline = []
    for ev in data["events"]:
        if ev.get("kind") == "supervisor":
            timeline.append(ev)
    for ev in data["obs_events"]:
        if ev.get("event") in _EVENT_KINDS:
            timeline.append(ev)
    timeline.sort(key=lambda e: e.get("unix", 0))
    # unclosed level begin marker = died mid-level
    open_level = None
    closed = {s.get("depth") for s in data["spans"]
              if s.get("span") == "level" and s.get("ph") == "E"}
    for s in data["spans"]:
        if s.get("span") == "level" and s.get("ph") == "B" \
                and s.get("depth") not in closed:
            open_level = s.get("depth")
    shard_procs = _shard_proc_summary(data)
    resource = _resource_pressure(data)
    vd = verdict(data, now=now)
    died = (
        _died_shards(shard_procs)
        if vd["status"] in ("crashed", "stalled")
        else []
    )
    return {
        "run_id": man.get("run_id") or os.path.basename(data["dir"]),
        "dir": data["dir"],
        "manifest": man,
        "verdict": vd,
        "levels": levels,
        "actions": actions,
        "spill": spill,
        "spans": span_agg,
        "timeline": timeline,
        "eta": eta(levels),
        "open_level": open_level,
        "shard_procs": shard_procs,
        "died_shards": died,
        "resource": resource,
        "integrity": _integrity(data),
        "overlap": _overlap(data),
        "launches": _launches(data),
        "host_probe": _host_probe(data),
    }


def _integrity(data: dict) -> dict:
    """Integrity beat (resilience.integrity): how many always-on checks
    and shadow samples ran, and any violation events."""
    snap = data.get("metrics") or {}
    counters = snap.get("counters") or {}
    return {
        "checks": counters.get("kspec_integrity_checks_total", 0),
        "shadow_samples": counters.get("kspec_integrity_shadow_total", 0),
        "violations": counters.get("kspec_integrity_violations_total", 0),
        "events": [
            e
            for e in data["obs_events"]
            if e.get("event") == "integrity-violation"
        ],
    }


def _launches(data: dict) -> dict:
    """Launches-per-level beat: the `kspec_successor_launches_level`
    gauge history (metrics snapshots) + the per-chunk `step` span
    launch counts.  <=2/level is the device-resident pipeline's launch
    contract; the fused path shows 2x chunks, legacy O(actions)x chunks
    — the emitted stats stream stays record-for-record historical, so
    this beat reads the gauge/span side channels only.  The sharded
    twin `kspec_shard_launches_level` counts dispatched collective-
    bearing programs per level (= launches PER SHARD): O(1)/level under
    the sharded device pipeline vs O(chunks) per-chunk."""
    series = []
    shard_series = []
    for snap in data.get("metrics_history") or ():
        g = snap.get("gauges") or {}
        v = g.get("kspec_successor_launches_level")
        if v is not None:
            series.append(v)
        sv = g.get("kspec_shard_launches_level")
        if sv is not None:
            shard_series.append(sv)
    last = (data.get("metrics") or {}).get("gauges") or {}
    out = {
        "series": series,
        "last": last.get("kspec_successor_launches_level"),
        "max": max(series) if series else None,
        "shard_series": shard_series,
        "shard_last": last.get("kspec_shard_launches_level"),
        "shard_max": max(shard_series) if shard_series else None,
    }
    out["present"] = (
        bool(series) or out["last"] is not None
        or bool(shard_series) or out["shard_last"] is not None
    )
    return out


def _host_probe(data: dict) -> dict:
    """Deferred batched host-probe beat: the `kspec_host_probe_ms`
    gauge history (metrics snapshots).  Set only by the host-backend
    device-resident pipelines — ONE batched FpSet / tiered-run probe
    per level — so its presence is itself the proof the deferred path
    engaged; the value is the per-level wall of that one call.  Reads
    the gauge side channel only (the emitted stats stream stays
    record-for-record historical, like the launch counters)."""
    series = []
    for snap in data.get("metrics_history") or ():
        v = (snap.get("gauges") or {}).get("kspec_host_probe_ms")
        if v is not None:
            series.append(v)
    last = ((data.get("metrics") or {}).get("gauges") or {}).get(
        "kspec_host_probe_ms"
    )
    return {
        "series": series,
        "last": last,
        "max": max(series) if series else None,
        "present": bool(series) or last is not None,
    }


def _overlap(data: dict) -> dict:
    """Async-overlap beat (KSPEC_OVERLAP, docs/engine.md § Async
    execution): how much storage/checkpoint/exchange wall hid behind
    device compute.  `kspec_overlap_efficiency` is the per-level gauge
    (1.0 = every background-I/O second overlapped; snapshots give its
    history), the io counters are run totals, and `exposed_io_stalled`
    is the machine-readable acceptance signal for ROADMAP item 2's
    "storage I/O fully hidden": True when more exposed than hidden I/O
    wall accumulated — the engine is stalling on I/O it should hide."""
    last = data.get("metrics") or {}
    counters = last.get("counters") or {}
    gauges = last.get("gauges") or {}
    series = []
    for snap in data.get("metrics_history") or ():
        v = (snap.get("gauges") or {}).get("kspec_overlap_efficiency")
        if v is not None:
            series.append(v)
    hidden = counters.get("kspec_io_hidden_ms_total", 0)
    exposed = counters.get("kspec_io_exposed_ms_total", 0)
    out = {
        "efficiency": gauges.get("kspec_overlap_efficiency"),
        "series": series,
        "io_hidden_ms": hidden,
        "io_exposed_ms": exposed,
        "exchange_bytes_level": gauges.get("kspec_exchange_bytes_level"),
        "exchange_compression_ratio": gauges.get(
            "kspec_exchange_compression_ratio"
        ),
        "exposed_io_stalled": bool(
            (hidden + exposed) > 0 and exposed > hidden
        ),
    }
    out["present"] = bool(
        series
        or hidden
        or exposed
        or out["efficiency"] is not None
        or out["exchange_compression_ratio"] is not None
    )
    return out


def _resource_pressure(data: dict) -> dict:
    """Disk/RSS pressure timeline (resilience.resources): gauge history
    across metric snapshots + reclaim / exhaustion events."""
    series: dict = {}
    for snap in data.get("metrics_history") or ():
        for key in (
            "kspec_disk_used_bytes",
            "kspec_rss_bytes",
        ):
            v = (snap.get("gauges") or {}).get(key)
            if v is not None:
                series.setdefault(key, []).append(v)
    last = data.get("metrics") or {}
    gauges = last.get("gauges") or {}
    events = [
        e
        for e in data["obs_events"]
        if e.get("event") in ("resource-pressure", "reclaim",
                              "resource-exhausted", "chunk-degrade")
    ]
    out = {
        "disk_used": gauges.get("kspec_disk_used_bytes"),
        "disk_budget": gauges.get("kspec_disk_budget_bytes"),
        "rss": gauges.get("kspec_rss_bytes"),
        "rss_budget": gauges.get("kspec_rss_budget_bytes"),
        "series": series,
        "events": events,
        "reclaims": (last.get("counters") or {}).get(
            "kspec_reclaims_total", 0
        ),
    }
    out["present"] = bool(
        events
        or out["disk_budget"]
        or out["rss_budget"]
        or any(series.values())
    )
    return out


def _last_level_record(stats_path: str, tail_bytes: int = 65536) -> dict:
    """Last "level" record of a stats.jsonl, reading only a bounded tail
    of the file — the run index must stay O(runs), not O(levels), and a
    long run's stats stream is thousands of lines.  The first line of the
    tail window may be torn by the seek (and the writer may have torn the
    final line mid-crash); both parse-fail and are skipped."""
    try:
        with open(stats_path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - tail_bytes))
            lines = fh.read().splitlines()
    except OSError:
        return {}
    for raw in reversed(lines):
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("kind") == "level":
            return rec
    return {}


def list_runs(root: str, limit: int = 20) -> list:
    """Index the run directories under `root`, newest first — the
    operator's ls once a serving daemon multiplies run dirs.  Each row is
    built from the manifest + last stats line only (no full report load:
    the index must stay O(runs), not O(levels))."""
    rows = []
    try:
        names = os.listdir(root)
    except OSError:
        return rows
    for name in names:
        d = os.path.join(root, name)
        man_path = os.path.join(d, "manifest.json")
        if not os.path.isfile(man_path):
            continue
        try:
            with open(man_path) as fh:
                man = json.load(fh)
        except (OSError, ValueError):
            man = {}
        cfg = man.get("config") or {}
        result = man.get("result") or {}
        last_level = _last_level_record(os.path.join(d, "stats.jsonl"))
        status = man.get("status", "?")
        if status == "running":
            # refine cheaply: a dead pid means crashed, not live
            if _pid_alive(man.get("pid")) is False:
                status = "crashed"
        try:
            mtime = os.path.getmtime(man_path)
        except OSError:
            mtime = 0
        rows.append({
            "run_id": man.get("run_id") or name,
            "dir": d,
            "status": status,
            "module": cfg.get("module") or cfg.get("model"),
            "engine": cfg.get("engine"),
            "service": (cfg.get("service") or {}).get("job_id"),
            "states": result.get("distinct_states")
            or last_level.get("total"),
            "states_per_sec": result.get("states_per_sec"),
            "depth": result.get("diameter") or last_level.get("depth"),
            "created": man.get("created"),
            "mtime": mtime,
        })
    rows.sort(key=lambda r: r["mtime"], reverse=True)
    return rows[:limit]


def render_run_index(root: str, rows: list) -> str:
    if not rows:
        return f"no runs under {root}"
    out = [f"Runs under {root} ({len(rows)} most recent):"]
    out.append(
        f"  {'run_id':<28} {'status':<12} {'module':<22} "
        f"{'states':>12} {'k/s':>8}  job"
    )
    for r in rows:
        sps = r.get("states_per_sec")
        out.append(
            f"  {str(r['run_id'])[:28]:<28} {str(r['status'])[:12]:<12} "
            f"{str(r.get('module') or '?')[:22]:<22} "
            f"{r.get('states') if r.get('states') is not None else '?':>12} "
            f"{(sps / 1e3 if sps else 0.0):>8.1f}  "
            f"{r.get('service') or ''}"
        )
    out.append("  (render one with `cli report <dir>` or `--latest`)")
    return "\n".join(out)


def _parse_prom(path: str) -> dict:
    """Parse one Prometheus textfile export into ``{key: value}``.

    The key is the metric name plus its labels with the daemon-identity
    labels (``run_id``, ``instance``, ``host``) stripped: every daemon
    stamps its own identity so scraped series never collide, but a
    cross-daemon rollup must sum ACROSS restarts and instances, not
    treat each incarnation as a new series.
    Histogram series are skipped — the rollup wants counters/gauges."""
    out: dict = {}
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError:
        return out
    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        try:
            key, val = ln.rsplit(" ", 1)
            value = float(val)
        except ValueError:
            continue
        base, _, labels = key.partition("{")
        if base.endswith(("_bucket", "_sum", "_count")):
            continue
        kept = [
            part for part in labels.rstrip("}").split(",")
            if part and not part.startswith(
                ("run_id=", "instance=", "host=")
            )
        ]
        if kept:
            out["{}{{{}}}".format(base, ",".join(sorted(kept)))] = value
        else:
            out[base] = value
    return out


# gauges describe the ONE shared queue every daemon of a host sees, so a
# per-host rollup takes the max across daemons instead of summing
_ROLLUP_GAUGES = (
    "kspec_svc_queue_pending",
    "kspec_svc_queue_claimed",
)


def host_metrics_rollup(service_dir: str) -> dict:
    """Sum every daemon's ``metrics*.prom`` under one host's service dir
    (counters summed, shared-queue gauges maxed) — the per-host row of
    the router report."""
    try:
        names = sorted(
            n for n in os.listdir(service_dir)
            if n.startswith("metrics") and n.endswith(".prom")
        )
    except OSError:
        names = []
    rolled: dict = {}
    for name in names:
        for key, value in _parse_prom(
            os.path.join(service_dir, name)
        ).items():
            base = key.partition("{")[0]
            if base in _ROLLUP_GAUGES:
                rolled[key] = max(rolled.get(key, 0.0), value)
            else:
                rolled[key] = rolled.get(key, 0.0) + value
    return rolled


def router_report_data(router_dir: str) -> dict:
    """The cross-host rollup for a router directory: per-host health +
    queue depths (the router's own view) joined with each host's summed
    daemon metrics, plus fleet-wide totals and the router event tally.
    Torch-free like everything in obs."""
    from ..service.router import Router

    router = Router(router_dir)
    data = router.overview()
    totals: dict = {}
    for h in data["hosts"]:
        rolled = host_metrics_rollup(os.path.join(h["dir"], "service"))
        h["metrics"] = rolled
        for key, value in rolled.items():
            # summing is right even for the queue gauges here: across
            # HOSTS they describe distinct queues
            totals[key] = totals.get(key, 0.0) + value
    data["totals"] = totals
    events: dict = {}
    for rec in read_jsonl_tolerant(router.events_path):
        kind = rec.get("event")  # records are kind="router", event=<what>
        if kind:
            events[kind] = events.get(kind, 0) + 1
    data["events"] = events
    return data


def render_router_report(data: dict) -> str:
    out = [
        f"Router {data['dir']}: {len(data['hosts'])} hosts, "
        f"{data['routes']} routed jobs, dead after "
        f"{data['dead_after_s']}s (+{data['clock_skew_s']}s skew "
        "allowance)"
    ]
    for h in data["hosts"]:
        age = h["hb_age_s"]
        m = h.get("metrics") or {}
        jobs = sum(
            v for k, v in m.items()
            if k.startswith("kspec_svc_jobs_total")
        )
        hits = m.get("kspec_svc_state_cache_hits_total", 0)
        falls = m.get("kspec_svc_state_cache_fallbacks_total", 0)
        out.append(
            f"  host{h['host']} [{h['state']:>6}] {h['dir']}: "
            f"{h['pending']} pending, {h['claimed']} in flight, "
            f"{jobs:.0f} verdicts, cache {hits:.0f} hits/"
            f"{falls:.0f} fallbacks, heartbeat "
            + ("never" if age is None else f"{age:.1f}s ago")
        )
    ev = data.get("events") or {}
    if ev:
        out.append(
            "  router events: "
            + ", ".join(f"{k}={ev[k]}" for k in sorted(ev))
        )
    t = data.get("totals") or {}
    done = sum(
        v for k, v in t.items() if k.startswith("kspec_svc_jobs_total")
    )
    out.append(
        f"  fleet totals: {done:.0f} verdicts, "
        f"{t.get('kspec_svc_state_cache_hits_total', 0):.0f} cache hits, "
        f"{t.get('kspec_svc_takeovers_total', 0):.0f} takeovers"
    )
    return "\n".join(out)


def sweep_report_data(sweep_dir: str) -> dict:
    """The sweep rollup for a sweep directory (``sweep.json``,
    kspec-sweep/1): coverage, the per-invariant minimal-violating-config
    frontier, scaling-law curves (states vs axis value), and estimator
    accuracy.  Torch-free like everything in obs."""
    from ..sweep.bisect import frontier_from_manifest
    from ..sweep.portfolio import load_manifest

    man = load_manifest(sweep_dir)
    points = man.get("points", {})
    counts = {"done": 0, "skipped": 0, "error": 0, "pending": 0,
              "submitted": 0, "hit": 0, "seeded": 0, "violations": 0}
    skipped_rows = []
    residuals = []
    ratios = []
    for row in points.values():
        st = row.get("status", "pending")
        counts[st] = counts.get(st, 0) + 1
        cache = row.get("cache") or {}
        if cache.get("state_cache") == "hit":
            counts["hit"] += 1
        elif cache.get("state_cache") == "seed":
            counts["seeded"] += 1
        if (row.get("verdict") or {}).get("violation"):
            counts["violations"] += 1
        if st == "skipped":
            skipped_rows.append({
                "point_id": row.get("point_id"),
                "coords": row.get("coords"),
                "skip": row.get("skip"),
            })
        if row.get("residual") is not None:
            residuals.append(float(row["residual"]))
            pred = (row.get("predicted") or {}).get("states")
            act = (row.get("actual") or {}).get("states")
            if pred and act:
                ratios.append(act / pred)
    # scaling laws: for each axis, median states among DONE clean rows
    # per axis value (in declared order) — the states-vs-config-size
    # curve the lattice exists to measure
    curves: dict = {}
    axis_order: dict = {}
    for sheet in (man.get("lattice") or {}).get("sheets", []):
        for axis in sheet.get("axes", []):
            axis_order.setdefault(axis["name"], list(axis["values"]))
    for name, values in axis_order.items():
        per_value: dict = {}
        for row in points.values():
            v = row.get("verdict") or {}
            if row.get("status") != "done" or v.get("violation"):
                continue
            if v.get("distinct_states") is None:
                continue
            for cname, cval in row.get("coords", []):
                if cname == name:
                    key = json.dumps(cval)
                    per_value.setdefault(key, []).append(
                        int(v["distinct_states"])
                    )
        curve = []
        for val in values:
            samples = sorted(per_value.get(json.dumps(val), []))
            if samples:
                curve.append({
                    "value": val,
                    "median_states": samples[len(samples) // 2],
                    "n": len(samples),
                })
        if len(curve) >= 2:
            curves[name] = curve
    acc = None
    if residuals:
        mean = sum(residuals) / len(residuals)
        acc = {
            "n": len(residuals),
            "mean_log_residual": round(mean, 3),
            "mean_abs_log_residual": round(
                sum(abs(r) for r in residuals) / len(residuals), 3
            ),
            # the operator-facing phrasing: actual = predicted * factor
            "median_actual_over_predicted": round(
                sorted(ratios)[len(ratios) // 2], 2
            ) if ratios else None,
        }
    return {
        "dir": sweep_dir,
        "schema": man.get("schema"),
        "sweep_id": man.get("sweep_id"),
        "name": man.get("name"),
        "points": len(points),
        "counts": counts,
        "skipped": skipped_rows,
        "frontiers": {
            inv: [
                {
                    "point_id": r.get("point_id"),
                    "coords": r.get("coords"),
                    "indices": r.get("_indices"),
                    "depth": (
                        (r.get("verdict") or {}).get("violation") or {}
                    ).get("depth"),
                }
                for r in rows
            ]
            for inv, rows in frontier_from_manifest(man).items()
        },
        "curves": curves,
        "estimator": acc,
        "cost_model": man.get("cost_model"),
    }


def render_sweep_report(data: dict) -> str:
    c = data["counts"]
    out = [
        f"Sweep {data['name']} ({data['sweep_id']}) — {data['points']} "
        f"points: {c['done']} done ({c['hit']} cache hits, "
        f"{c['seeded']} seeded), {c['skipped']} skipped, "
        f"{c['error']} errors, {c['pending'] + c['submitted']} pending, "
        f"{c['violations']} violations"
    ]
    if data["skipped"]:
        out.append("  skipped (statically vacuous — auditable, typed):")
        for row in data["skipped"][:8]:
            finds = (row.get("skip") or {}).get("findings") or []
            acts = ", ".join(
                f.get("target", "?") for f in finds[:3]
            )
            out.append(
                f"    {dict(row.get('coords') or [])}: "
                f"skipped: vacuous [{acts}]"
            )
        if len(data["skipped"]) > 8:
            out.append(f"    ... and {len(data['skipped']) - 8} more")
    for inv, rows in sorted((data.get("frontiers") or {}).items()):
        out.append(f"  minimal violating configs — {inv}:")
        for r in rows:
            out.append(
                f"    {dict(r.get('coords') or [])}"
                + (
                    f" (violates at depth {r['depth']})"
                    if r.get("depth") is not None
                    else ""
                )
            )
    for name, curve in sorted((data.get("curves") or {}).items()):
        states = [pt["median_states"] for pt in curve]
        out.append(
            f"  scaling law — states vs {name}: "
            f"{_spark(states)}  "
            + " ".join(
                f"{pt['value']}→{pt['median_states']}" for pt in curve
            )
        )
    acc = data.get("estimator")
    if acc:
        out.append(
            f"  estimator: {acc['n']} residuals, mean log error "
            f"{acc['mean_log_residual']:+.3f} (abs "
            f"{acc['mean_abs_log_residual']:.3f}), median actual/"
            f"predicted {acc['median_actual_over_predicted']}"
        )
    cm = data.get("cost_model") or {}
    if cm.get("n_records"):
        out.append(
            f"  cost model: fit over {cm['n_records']} corpus records, "
            f"throughput {cm.get('states_per_sec')}/s, recalibration "
            f"shift {cm.get('residual_shift', 0):+.3f}"
        )
    return "\n".join(out)


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:,.0f}{unit}" if unit == "B" else f"{n:,.1f}{unit}"
        n /= 1024
    return f"{n:,.1f}TiB"


def render_report(run_dir: str, now: Optional[float] = None,
                  max_rows: int = 40) -> str:
    r = report_data(run_dir, now=now)
    man, levels = r["manifest"], r["levels"]
    cfg = man.get("config") or {}
    out = []
    v = r["verdict"]
    out.append(f"Run {r['run_id']}  [{v['status'].upper()}]")
    svc = cfg.get("service") or {}
    if svc:
        # checking-as-a-service run: which job/tenant this run served and
        # whether it rode the warm compile cache / a batched group
        out.append(
            "  service: job "
            + str(svc.get("job_id", "?"))
            + f"  tenant {svc.get('tenant', '?')}"
            + (
                f"  batched x{svc['group_size']}"
                if svc.get("group_size", 1) > 1
                else ""
            )
            + (
                "  compile-cache HIT"
                if svc.get("cache_hit")
                else "  compile-cache miss (cold shape)"
            )
            + (
                f"  leader run {svc['leader_run_id']}"
                if svc.get("leader_run_id")
                else ""
            )
            + (
                "  state-cache SEED"
                if svc.get("state_cache_seed")
                else ""
            )
        )
        if svc.get("takeover"):
            # lease takeover: this run serves a job a DIFFERENT daemon
            # claimed first and abandoned (died or wedged); the janitor
            # attribution rides the job spec into the run manifest
            t = svc["takeover"]
            out.append(
                "  takeover: requeued from pid "
                + str(t.get("from_pid", "?"))
                + f" ({t.get('reason', '?')})"
                + f" by janitor pid {t.get('by_pid', '?')}"
            )
    bits = [
        f"module={cfg.get('module') or cfg.get('model') or '?'}",
        f"engine={cfg.get('engine', '?')}",
    ]
    if cfg.get("platform"):
        bits.append(f"platform={cfg['platform']}")
    if man.get("git"):
        bits.append(f"git={man['git']}")
    if cfg.get("mem_budget"):
        bits.append(f"mem_budget={cfg['mem_budget']}")
    restarts = sum(
        1 for e in r["timeline"]
        if e.get("kind") == "supervisor" and e.get("event") == "restart"
    )
    if restarts:
        bits.append(f"restarts={restarts}")
    out.append("  " + "  ".join(bits))
    if v["detail"]:
        out.append("  " + json.dumps(v["detail"], default=str))
    if v["status"] == "resource-exhausted":
        # the verdict beat: this run did NOT crash — it checkpointed and
        # exited typed (exit code 75) because it ran out of something;
        # tell the operator exactly what to do next
        d = v["detail"] or {}
        out.append(
            f"  RESOURCE EXHAUSTED: {d.get('reason', '?')} at level "
            f"{d.get('depth', '?')} after {d.get('distinct_states', '?')} "
            f"distinct states — clean typed exit, checkpoint intact."
        )
        out.append(
            "  next: free space (or raise --disk-budget), confirm with "
            "`cli verify-checkpoint`, then re-run the same command to "
            "resume — or supervise with --reclaim for one automatic "
            "prune-and-retry."
        )
    if v["status"] == "integrity-violation":
        # the verdict beat: a state-integrity check tripped (exit code
        # 76) — the run's data, not its progress, was the problem
        d = v["detail"] or {}
        out.append(
            f"  INTEGRITY VIOLATION: site {d.get('site', '?')} at level "
            f"{d.get('depth', '?')} after {d.get('distinct_states', '?')} "
            f"distinct states — silent corruption detected, typed exit."
        )
        out.append(
            "  next: `cli verify-checkpoint` shows which generations are "
            "chain-verified; re-running resumes from the newest one "
            "(corrupted generations are skipped automatically).  "
            "Recurring violations on one host suggest failing "
            "hardware — re-run the single-device engine with "
            "`--integrity-shadow 1.0` to localize."
        )
    integ = r.get("integrity") or {}
    if integ.get("checks") or integ.get("shadow_samples") \
            or integ.get("violations"):
        out.append(
            f"  integrity: {integ.get('checks', 0)} checks, "
            f"{integ.get('shadow_samples', 0)} shadow samples, "
            f"{integ.get('violations', 0)} violations"
        )
    ov = r.get("overlap") or {}
    if ov.get("present"):
        eff = ov.get("efficiency")
        bits = []
        if eff is not None:
            bits.append(f"overlap efficiency {eff:.0%}"
                        + (" " + _spark(ov["series"])
                           if ov.get("series") else ""))
        bits.append(
            f"I/O hidden {ov.get('io_hidden_ms', 0):.0f}ms / exposed "
            f"{ov.get('io_exposed_ms', 0):.0f}ms"
        )
        if ov.get("exchange_compression_ratio"):
            bits.append(
                f"exchange compressed {ov['exchange_compression_ratio']}x"
            )
        out.append("  overlap: " + "  ".join(bits))
        if ov.get("exposed_io_stalled"):
            # the exposed-I/O stall beat: ROADMAP item 2's acceptance
            # ("storage I/O fully hidden") made machine-readable — more
            # I/O wall was exposed on the critical path than hidden
            out.append(
                "  EXPOSED-I/O STALL: more storage/checkpoint wall "
                "landed on the critical path than was hidden behind "
                "compute — check --overlap is on, and whether the "
                "spill disk or checkpoint cadence is outrunning the "
                "per-level compute budget."
            )
    ln = r.get("launches") or {}
    if ln.get("present"):
        # launches/level beat: the device-resident pipeline's contract
        # is <=2 per level; fused shows 2x chunks, legacy O(actions)x
        bits = []
        if ln.get("last") is not None or ln.get("series"):
            bits.append(f"successor launches/level last {ln.get('last')}")
            if ln.get("series"):
                bits.append(f"max {ln['max']} " + _spark(ln["series"]))
        if ln.get("shard_last") is not None or ln.get("shard_series"):
            # sharded twin: dispatched collective-bearing programs per
            # level = launches PER SHARD (O(1) under --pipeline device)
            bits.append(
                f"launches/level/shard last {ln.get('shard_last')}"
            )
            if ln.get("shard_series"):
                bits.append(
                    f"max {ln['shard_max']} " + _spark(ln["shard_series"])
                )
        out.append("  launches: " + "  ".join(bits))
    hp = r.get("host_probe") or {}
    if hp.get("present"):
        # probe-ms/level beat, next to the launches sparkline: the
        # deferred-probe device path's host-sync wall — ONE batched
        # FpSet/tiered-run call per level on the host backend
        bits = [f"host-probe ms/level last {hp.get('last')}"]
        if hp.get("series"):
            bits.append(f"max {hp['max']} " + _spark(hp["series"]))
        out.append("  probe: " + "  ".join(bits))
    if r["open_level"] is not None and v["status"] in ("crashed", "stalled"):
        out.append(f"  died mid-level: level {r['open_level']} began but "
                   f"never completed")
    if r["died_shards"] and v["status"] in ("crashed", "stalled"):
        # multiprocess attribution: WHICH process took the run down (its
        # peers wedge in the next collective, so the laggard is causal)
        for p in r["died_shards"]:
            shards = p.get("shards") or []
            out.append(
                "  attributed to shard(s) "
                + ",".join(str(s) for s in shards)
                + f" (process {p['proc']}, pid {p['pid']}"
                + (", pid dead" if p["alive"] is False else "")
                + f", last completed level {p['last_depth']})"
            )
    if r["shard_procs"] and len(r["shard_procs"]) > 1:
        depths = [p["last_depth"] for p in r["shard_procs"]]
        out.append(
            f"  processes: {len(r['shard_procs'])}; last completed level "
            f"per process {depths}"
        )
    # --- levels table -----------------------------------------------------
    if levels:
        out.append("")
        out.append("Per-level throughput "
                   f"({len(levels)} levels recorded):")
        out.append(
            f"  {'depth':>5} {'frontier':>10} {'new':>10} {'dup%':>6} "
            f"{'wall':>8} {'kstates/s':>10}"
        )
        rows = levels if len(levels) <= max_rows else (
            levels[: max_rows // 2] + [None] + levels[-max_rows // 2:]
        )
        for rec in rows:
            if rec is None:
                out.append(f"  {'...':>5}")
                continue
            en = rec.get("enabled_candidates", 0)
            dup = rec.get("duplicates", 0)
            ms = rec.get("level_ms", 0.0)
            sps = rec.get("new", 0) / (ms / 1e3) if ms else 0.0
            out.append(
                f"  {rec.get('depth', '?'):>5} {rec.get('frontier', 0):>10,}"
                f" {rec.get('new', 0):>10,}"
                f" {100.0 * dup / en if en else 0.0:>5.1f}%"
                f" {_fmt_dur(ms / 1e3):>8} {sps / 1e3:>10.1f}"
            )
        sps_curve = [
            rec.get("new", 0) / (rec.get("level_ms", 0) / 1e3)
            if rec.get("level_ms") else 0.0
            for rec in levels
        ]
        out.append(f"  states/sec  {_spark(sps_curve)}")
        out.append(f"  new/level   "
                   f"{_spark([rec.get('new', 0) for rec in levels])}")
        total = levels[-1].get("total")
        if total:
            out.append(f"  total distinct so far: {total:,}")
        shard_new = levels[-1].get("shard_new")
        if shard_new:
            mean = sum(shard_new) / len(shard_new)
            imb = max(shard_new) / mean if mean else 0.0
            out.append(
                f"  shards: {len(shard_new)}; last-level new per shard "
                f"{_spark(shard_new)} (imbalance max/mean {imb:.2f})"
            )
    else:
        out.append("")
        out.append("No per-level stats recorded (yet).")
    # --- action enablement ------------------------------------------------
    if r["actions"]:
        out.append("")
        out.append("Action enablement (cumulative successors per action):")
        tot = sum(r["actions"].values()) or 1
        width = max(len(n) for n in r["actions"])
        for name, c in sorted(r["actions"].items(), key=lambda kv: -kv[1]):
            out.append(f"  {name:<{width}} {c:>12,}  {100.0 * c / tot:>5.1f}%")
    # --- spill accounting -------------------------------------------------
    if r["spill"] or any(k.startswith("spill-") for k in r["spans"]):
        out.append("")
        out.append("Disk-tier (spill) accounting:")
        for k in sorted(r["spill"]):
            out.append(f"  {k} = {r['spill'][k]}")
        for k in ("spill-run-write", "spill-merge"):
            if k in r["spans"]:
                a = r["spans"][k]
                out.append(
                    f"  {k}: {a['count']}x, {_fmt_dur(a['ms'] / 1e3)} total"
                )
    # --- resource pressure ------------------------------------------------
    res = r.get("resource") or {}
    if res.get("present"):
        out.append("")
        out.append("Resource pressure (disk / RSS gauges, "
                   "reclaim + exhaustion events):")
        if res.get("disk_budget"):
            used, bud = res.get("disk_used"), res["disk_budget"]
            pct = 100.0 * used / bud if used is not None and bud else 0.0
            out.append(
                f"  disk  {_fmt_bytes(used)} / {_fmt_bytes(bud)} budget "
                f"({pct:.0f}%)  {_spark(res['series'].get('kspec_disk_used_bytes', []))}"
            )
        elif res["series"].get("kspec_disk_used_bytes"):
            out.append(
                f"  disk  {_fmt_bytes(res.get('disk_used'))} used "
                f"(no budget)  "
                f"{_spark(res['series'].get('kspec_disk_used_bytes', []))}"
            )
        if res.get("rss") is not None:
            bud = res.get("rss_budget")
            out.append(
                f"  rss   {_fmt_bytes(res['rss'])}"
                + (f" / {_fmt_bytes(bud)} budget" if bud else "")
                + f"  {_spark(res['series'].get('kspec_rss_bytes', []))}"
            )
        if res.get("reclaims"):
            out.append(f"  reclaims: {res['reclaims']}")
        for ev in res.get("events", [])[-8:]:
            extra = {
                k: v2
                for k, v2 in ev.items()
                if k not in ("kind", "ts", "unix", "event", "run_id")
            }
            out.append(f"  {ev.get('ts', '?')}  {ev.get('event')}  "
                       f"{json.dumps(extra, default=str)}")
    # --- timeline ---------------------------------------------------------
    if r["timeline"]:
        out.append("")
        out.append("Restart / fallback timeline:")
        for ev in r["timeline"][-20:]:
            what = ev.get("event", "?")
            extra = {
                k: v
                for k, v in ev.items()
                if k not in ("kind", "ts", "unix", "event", "run_id", "cmd")
            }
            out.append(f"  {ev.get('ts', '?')}  {what}  "
                       f"{json.dumps(extra, default=str)}")
    # --- ETA --------------------------------------------------------------
    e = r["eta"]
    out.append("")
    if v["status"] in ("complete", "violation"):
        res = man.get("result") or {}
        out.append(
            f"ETA: run finished — {res.get('distinct_states', '?')} states, "
            f"diameter {res.get('diameter', '?')}, "
            f"{_fmt_dur(res.get('seconds'))}"
        )
    elif e.get("status") == "fit":
        if "eta_seconds" in e:
            out.append(
                f"ETA: frontier decaying x{e['growth_ratio']}/level — "
                f"~{e['est_remaining_states']:,} states remain, "
                f"~{_fmt_dur(e['eta_seconds'])} at "
                f"{e['recent_states_per_sec']:,.0f} states/sec"
            )
        else:
            out.append(
                f"ETA: frontier growth x{e['growth_ratio']}/level — "
                f"unbounded (sustaining "
                f"{e.get('recent_states_per_sec') or 0:,.0f} states/sec)"
            )
    else:
        out.append("ETA: insufficient data (needs >= 3 levels of stats)")
    out.append(f"Stall verdict: {v['status']}")
    return "\n".join(out)
