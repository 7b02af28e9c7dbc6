"""PyTorch port: the fleet trace plane's reassembly (obs/fleettrace.py:
`load_trace`, `assemble`, `render_trace`, `fleet_report_data`, `top_data`,
the vocabulary lint) and its verbs (`cli trace`, `top`, `fleet-report`,
`analyze`'s trace-vocab target) against the JAX package's, on the CPU.
Both packages read the SAME directories (synthetic skewed records, traces
a port daemon wrote, a JAX daemon's, and a router's), and their records
and text must be equal; the verbs' exit codes too.  The report's service
header and the host rollup (obs/report.py) are held the same way."""

import json
import os

import pytest

from kafka_specification_tpu.obs import fleettrace as jft
from kafka_specification_tpu.obs import report as jreport
from kafka_specification_tpu.service.daemon import Daemon as JDaemon
from kafka_specification_tpu.service.daemon import ServeConfig as JServeConfig
from kafka_specification_tpu.utils import cli as jcli
from kafka_specification_tpu.utils import clock as jclock
from kafka_specification_tpu_torch import cli
from kafka_specification_tpu_torch.obs import fleettrace as ft
from kafka_specification_tpu_torch.obs import report as treport
from kafka_specification_tpu_torch.obs.metrics import MetricsRegistry
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.service.queue import JobQueue
from kafka_specification_tpu_torch.service.router import Router
from kafka_specification_tpu_torch.utils import clock as tclock
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.obs

ID_CFG = """
SPECIFICATION Spec
CONSTANTS
    MaxId = 6
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""
TTW_CFG = """
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 1
    MaxLeaderEpoch = 1
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("KSPEC_FAULT", "KSPEC_HOST_INSTANCE", "KSPEC_DAEMON_INSTANCE"):
        monkeypatch.delenv(k, raising=False)


class FrozenClock(tclock.Clock):
    """Both packages read `now` through their clock seam: freeze it, so the
    heartbeat ages `top` prints are the same in both renderings."""

    def __init__(self, t):
        self.t = t

    def now(self):
        return self.t

    def monotonic(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


@pytest.fixture
def frozen():
    c = FrozenClock(2_000_000_000.0)
    tclock.install(c)
    jclock.install(c)
    yield c
    tclock.install(None)
    jclock.install(None)


def _rec(kind, span, t0, ms, host, pid=1, anchor=1000.0, **extra):
    rec = {"kind": kind, "trace_id": "tr-j", "job_id": "j", "anchor_unix": anchor,
           "host": host, "pid": pid, **extra}
    if kind == "span":
        rec.update(span=span, t0=t0, ms=ms, unix=t0 + ms / 1e3)
    else:
        rec.update(event=span, unix=t0)
    return rec


SKEWED = [
    _rec("span", "job-submit", 1000.0, 50.0, host="0"),
    _rec("span", "route-place", 1000.05, 3.0, host=None, pid=9),
    _rec("span", "queue-claim", 998.5, 10.0, host="1"),  # host 1 runs 2 s behind
    _rec("span", "sched-group", 998.52, 1.0, host="1"),
    _rec("span", "cache-lookup", 998.53, 2.0, host="1", outcome="miss"),
    _rec("span", "svc-run", 998.6, 200.0, host="1", compile_ms=40.0, run_id="r1",
         states=353),
    _rec("span", "cache-publish", 998.85, 4.0, host="1"),
    _rec("span", "verdict-publish", 998.9, 5.0, host="1", verdict="complete"),
    _rec("event", "queue-requeue", 998.55, 0.0, host="1", reason="dead-pid", from_pid=4),
    _rec("event", "route-reroute", 1000.1, 0.0, host=None, pid=9, from_host=0, to_host=1,
         why="host-dead"),
]


@pytest.mark.parametrize("records", [
    SKEWED,
    SKEWED[:3],  # incomplete: no verdict-publish
    [_rec("span", "job-submit", 1000.0, 50.0, host="0"),
     _rec("span", "queue-claim", 1003.0, 10.0, host="1")],  # a clock ahead
    [],
], ids=["skewed", "incomplete", "ahead", "empty"])
def test_assemble_and_render_trace_equal_jax(records):
    t = ft.assemble([dict(r) for r in records], job_id="j")
    j = jft.assemble([dict(r) for r in records], job_id="j")
    assert t == j
    assert ft.render_trace(t) == jft.render_trace(j)
    assert all(v is None or v >= 0 for v in t["stages"].values())
    if records is SKEWED:
        assert t["shifts"] == {"1:1": 1.5} and t["complete"]
        assert t["stages"]["compile"] == 40.0 and t["stages"]["explore"] == 160.0


def _serve_jobs(svc, daemon, cfg, queue):
    q = queue(svc)
    ids = [q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"],
           q.submit(TTW_CFG, "KafkaTruncateToHighWatermark", kernel_source="hand")["job_id"]]
    d = daemon(cfg)
    assert d.drain_once() == 2
    ids.append(q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"])  # a hit
    assert d.drain_once() == 1
    d._heartbeat(pending=0)
    d._export_metrics(jsonl=True)
    return ids


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port daemon's and a JAX daemon's service directories, three jobs each
    (a cold pair batched, then a verified hit), plus a router over both."""
    root = tmp_path_factory.mktemp("served")
    t, j = str(root / "t"), str(root / "j")
    from kafka_specification_tpu.service.queue import JobQueue as JJobQueue

    tids = _serve_jobs(t, Daemon, ServeConfig(t, device="cpu", linger_s=0.0, min_bucket=32),
                       JobQueue)
    jids = _serve_jobs(j, JDaemon, JServeConfig(service_dir=j, linger_s=0.0, min_bucket=32),
                       JJobQueue)
    rt = str(root / "rt")
    Router(rt, hosts=[t, j], dead_after_s=30.0)
    return {"t": t, "j": j, "tids": tids, "jids": jids, "rt": rt, "root": str(root)}


@pytest.mark.parametrize("side", ["t", "j"])
def test_reassembly_of_daemon_traces_equals_jax(served, side, frozen):
    """Traces written by either package's daemon: every job's assembled
    record and waterfall, the fleet report and the `top` frame are the
    same when the port and JAX read them."""
    root = served[side]
    ids = served[side + "ids"]
    assert ft.list_trace_jobs([root]) == jft.list_trace_jobs([root]) == sorted(ids)
    for jid in ids:
        recs = ft.load_trace([root], jid)
        assert recs == jft.load_trace([root], jid)
        t, j = ft.assemble(recs, job_id=jid), jft.assemble(recs, job_id=jid)
        assert t == j and t["complete"]
        assert ft.render_trace(t) == jft.render_trace(j)
        spans = [r["span"] for r in t["spans"]]
        # spans sort by their start in ms, then by name: a hit can be
        # submitted, claimed and looked up within one ms, and then
        # cache-lookup sorts first; the submit starts no later than any
        assert "job-submit" in spans and "queue-claim" in spans
        submit = next(r for r in t["spans"] if r["span"] == "job-submit")
        assert submit["t0n"] == min(r["t0n"] for r in t["spans"])
        assert "verdict-publish" in spans
    rep_t, rep_j = ft.fleet_report_data([root]), jft.fleet_report_data([root])
    assert rep_t == rep_j and rep_t["completed"] == 3 and rep_t["cache"]["hit"] == 1
    assert ft.render_fleet_report(rep_t) == jft.render_fleet_report(rep_j)
    top_t, top_j = ft.top_data([root]), jft.top_data([root])
    assert top_t == top_j
    assert ft.render_top(top_t) == jft.render_top(top_j)
    assert treport.host_metrics_rollup(os.path.join(root, "service")) == \
        jreport.host_metrics_rollup(os.path.join(root, "service"))


def _verbs(main, served, capsys):
    rt, t = served["rt"], served["t"]
    jid = served["tids"][1]
    out = []
    for args in (["trace", jid, "--service-dir", t], ["trace", jid, "--router", rt],
                 ["trace", jid, "--router", rt, "--json"], ["trace", "nope", "--service-dir", t],
                 ["top", "--once", "--router", rt], ["top", "--json", "--service-dir", t],
                 ["fleet-report", "--router", rt], ["fleet-report", "--service-dir", t,
                                                     "--json"],
                 ["report", rt], ["trace", jid, "--router", served["root"] + "/nope"]):
        rc = main(args)
        o, e = capsys.readouterr()
        out.append((rc, o, (e.strip().splitlines() or [""])[-1]))
    return out


def test_trace_top_fleet_report_verbs_equal_jax(served, capsys, frozen):
    """The three verbs and `report <router dir>` on the same directories:
    the same exit codes, records and text (the router's heartbeat ages on
    a frozen clock)."""
    t = _verbs(cli.main, served, capsys)
    j = _verbs(jcli.main, served, capsys)
    assert [x[0] for x in t] == [0, 0, 0, 1, 0, 0, 0, 0, 0, 2]
    assert t == j
    assert "verdict-publish" in t[0][1] and "Router" in t[8][1]


def test_render_report_service_header_equals_jax(served):
    """A job's run directory renders JAX's service header (job, tenant,
    batching, the model cache) in the port's `cli report`."""
    runs = os.path.join(served["t"], "runs")
    for name in sorted(os.listdir(runs)):
        d = os.path.join(runs, name)
        tr, jr = treport.render_report(d, now=1.0), jreport.render_report(d, now=1.0)
        assert tr.splitlines()[:2] == jr.splitlines()[:2]
        assert tr.splitlines()[1].startswith("  service: job ")


def test_trace_vocabulary_lint_clean_and_catches_drift_as_jax(tmp_path):
    assert ft.lint_trace_vocabulary() == []
    for reg in ("SPAN_KINDS", "EVENT_KINDS", "ENGINE_SPAN_KINDS", "ENGINE_EVENT_KINDS",
                "STAGES"):
        assert getattr(ft, reg) == getattr(jft, reg), reg
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "x.py").write_text(
        'def f(tracer, root, trace):\n'
        '    with tracer.span("not-a-kind", depth=1):\n'
        '        emit_span(root, trace, "svc-runn", 0, 1, job_id="j")\n')
    docs = tmp_path / "observability.md"
    docs.write_text("`level` `svc-run`")
    kw = dict(package_root=str(pkg), docs_path=str(docs))
    probs = ft.lint_trace_vocabulary(**kw)
    assert probs == jft.lint_trace_vocabulary(**kw)
    assert [(p["kind"], p["line"]) for p in probs[:2]] == [("not-a-kind", 2), ("svc-runn", 3)]
    assert {p["problem"] for p in probs[2:]} == {"registered kind missing from docs"}


def test_analyze_trace_vocab_target(monkeypatch, capsys):
    """`cli analyze` runs the lint over the port's sources: the target is
    listed and clean; a drifted kind is a HIGH trace-vocab finding (exit
    1), as in JAX's."""
    assert cli.main(["analyze", "--no-models", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["targets"] == ["engine sources (ownership + purity)",
                              "trace vocabulary (obs/fleettrace registries)",
                              "durable-write discipline (durable_io boundary)",
                              "raw-clock discipline (utils/clock boundary)"]
    assert not [f for f in rec["findings"] if f["kind"] == "trace-vocab"]
    monkeypatch.setattr(ft, "lint_trace_vocabulary", lambda *a, **k: [
        {"path": "x.py", "line": 3, "kind": "bogus",
         "problem": "unregistered fleet span kind"}])
    assert cli.main(["analyze", "--no-models"]) == 1
    out = capsys.readouterr().out
    assert "trace-vocab" in out and "x.py:3" in out


def test_metrics_const_labels_roll_up_as_jax(tmp_path):
    """Two daemons' metrics-<i>.prom under one host: the rollup strips the
    identity labels, sums counters and maxes the shared-queue gauges."""
    svc = tmp_path / "service"
    svc.mkdir()
    for i in (0, 1):
        m = MetricsRegistry(run_id=f"service-{i}", const_labels={"instance": str(i),
                                                                 "host": "0"})
        m.inc("kspec_svc_jobs_total", 2 + i, status="complete")
        m.set_gauge("kspec_svc_queue_pending", 5 - i)
        m.observe("kspec_svc_stage_queue_wait_ms", 10.0 * (i + 1))
        m.write_prom(str(svc / f"metrics-{i}.prom"))
    t = treport.host_metrics_rollup(str(svc))
    assert t == jreport.host_metrics_rollup(str(svc))
    assert t['kspec_svc_jobs_total{status="complete"}'] == 5.0
    assert t["kspec_svc_queue_pending"] == 5.0
