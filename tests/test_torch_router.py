"""PyTorch port: the cross-host router (service/router.py, `cli route`,
`--router` on the client verbs) and the host faults against the JAX
package's, on the CPU.  Placement and admission on two identical pairs of
host directories choose the same hosts as JAX's Router; a port router
fronts one host served by a JAX daemon and one by a port daemon; a dead
host's pending jobs are re-routed exactly once with a port router and a
JAX router sweeping the same router directory at once; kill@host,
partition@host and skew@host run through the port's daemon and queue (the
skew on a virtual clock), with the daemon's events equal to JAX's; the
CLI's records, text and exit codes equal JAX's on the same directories.
The torch-free client path is held in tests/test_torch_imports.py."""

import json
import os
import threading
import time

import pytest

from kafka_specification_tpu.resilience.faults import FaultPlan as JFaultPlan
from kafka_specification_tpu.service import state_cache as jstate_cache
from kafka_specification_tpu.service.daemon import Daemon as JDaemon
from kafka_specification_tpu.service.daemon import ServeConfig as JServeConfig
from kafka_specification_tpu.service.queue import JobQueue as JJobQueue
from kafka_specification_tpu.service.router import Router as JRouter
from kafka_specification_tpu.service.router import classify_host as jclassify_host
from kafka_specification_tpu.utils import cli as jcli
from kafka_specification_tpu.utils import clock as jclock
from kafka_specification_tpu_torch import check, cli
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.resilience import faults as tfaults
from kafka_specification_tpu_torch.resilience.faults import FaultPlan
from kafka_specification_tpu_torch.service import state_cache as tstate_cache
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.service.queue import JobQueue
from kafka_specification_tpu_torch.service.router import (
    AdmissionDenied,
    Router,
    classify_host,
)
from kafka_specification_tpu_torch.utils import clock as tclock
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.router

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
THW = "KafkaTruncateToHighWatermark"


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("KSPEC_FAULT", "KSPEC_HOST_INSTANCE", "KSPEC_DAEMON_INSTANCE",
              "KSPEC_CLOCK_SKEW", "KSPEC_CLAIM_LEASE_TTL"):
        monkeypatch.delenv(k, raising=False)
    tstate_cache._publish_ordinal["n"] = 0
    jstate_cache._publish_ordinal["n"] = 0


def hb(host_dir, t=None):
    """One heartbeat record in a host's service dir (what a daemon writes)."""
    svc = os.path.join(str(host_dir), "service")
    os.makedirs(svc, exist_ok=True)
    with open(os.path.join(svc, "heartbeat.jsonl"), "a") as fh:
        fh.write(json.dumps({"kind": "service-heartbeat",
                             "unix": round(time.time() if t is None else t, 3)}) + "\n")


def events(svc, name="events.jsonl"):
    try:
        with open(os.path.join(str(svc), "service", name)) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    except OSError:
        return []


def two_hosts(root, router_cls, queue_cls, dead_after=2.0):
    h0, h1 = str(root / "h0"), str(root / "h1")
    queue_cls(h0)
    queue_cls(h1)
    return router_cls(str(root / "rt"), hosts=[h0, h1], dead_after_s=dead_after), h0, h1


def test_classify_host_equals_jax():
    for seen in (False, True):
        for alive in (False, True):
            assert classify_host(seen, alive) == jclassify_host(seen, alive)
    assert [classify_host(False, False), classify_host(True, True),
            classify_host(True, False)] == ["unseen", "ok", "dead"]


def test_placement_and_admission_choose_jax_hosts(tmp_path):
    """The same operations on two identical pairs of hosts: every submit
    lands on the host JAX's Router picks (unseen hosts deprioritized,
    module affinity, least-loaded), the route records agree, and the
    fleet-wide max_pending cap refuses the same submit."""
    sides = {}
    for name, rcls, qcls in (("t", Router, JobQueue), ("j", JRouter, JJobQueue)):
        (tmp_path / name).mkdir()
        sides[name] = two_hosts(tmp_path / name, rcls, qcls)
    now = time.time()
    chosen = {"t": [], "j": []}
    for name, (r, h0, h1) in sides.items():
        hb(h1, now)
        chosen[name].append(r.submit(ID_CFG, "IdSequence", tenant="t",
                                     kernel_source="hand")["host"])
        hb(h0, now)
        chosen[name].append(r.submit(ID_CFG, "IdSequence", tenant="t",
                                     kernel_source="hand")["host"])
        chosen[name].append(r.submit(TTW_CFG, THW, tenant="t",
                                     kernel_source="hand")["host"])
        with open(r.tenants_path, "w") as fh:
            json.dump({"capped": {"max_pending": 2}}, fh)
        for _ in range(2):
            chosen[name].append(r.submit(ID_CFG, "IdSequence", tenant="capped",
                                         kernel_source="hand")["host"])
        try:
            r.submit(ID_CFG, "IdSequence", tenant="capped", kernel_source="hand")
            chosen[name].append("admitted")
        except RuntimeError as e:
            chosen[name].append(type(e).__name__)
        chosen[name].append(r.submit(ID_CFG, "IdSequence", tenant="other",
                                     kernel_source="hand")["host"])
        chosen[name].append([(h["state"], h["pending"]) for h in r.healths()])
    assert chosen["t"] == chosen["j"]
    assert chosen["t"][:3] == [1, 1, 0] and chosen["t"][5] == "AdmissionDenied"
    with pytest.raises(AdmissionDenied):
        sides["t"][0].submit(ID_CFG, "IdSequence", tenant="capped", kernel_source="hand")


def test_port_router_fronts_a_jax_host_and_a_port_host(tmp_path):
    """Host 0 served by the JAX package's daemon, host 1 by the port's: the
    port's router places, resolves and returns both verdicts, and each
    equals a solo check of the same config."""
    r, h0, h1 = two_hosts(tmp_path, Router, JobQueue)
    hb(h0)
    hb(h1)
    j0 = r.submit(ID_CFG, "IdSequence", kernel_source="hand", host=0)["job_id"]
    j1 = r.submit(TTW_CFG, THW, kernel_source="hand", host=1)["job_id"]
    assert JDaemon(JServeConfig(service_dir=h0, linger_s=0.0, min_bucket=32)).drain_once() == 1
    assert Daemon(ServeConfig(h1, device="cpu", linger_s=0.0, min_bucket=32)).drain_once() == 1
    assert r.status(j0)["host"] == 0 and r.status(j1)["host"] == 1
    r0, r1 = r.wait_result(j0, timeout=5), r.wait_result(j1, timeout=5)
    assert (r0["distinct_states"], r0["exit_code"]) == (8, 0)
    solo = check(tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk",)), device="cpu",
                 min_bucket=32)
    assert (r1["distinct_states"], r1["diameter"]) == (solo.total, solo.diameter)
    # the JAX router reads the same directory alike
    jr = JRouter(r.dir)
    assert jr.result(j0)["distinct_states"] == 8 and jr.locate(j1) == 1


def test_dead_host_rerouted_exactly_once_under_two_routers(tmp_path):
    """Host 0 dies with 6 jobs pending; the port's router and JAX's sweep the
    same router directory at once.  Every job lands on host 1 exactly once,
    with one re-route stamp and one route-history hop."""
    r, h0, h1 = two_hosts(tmp_path, Router, JobQueue)
    hb(h0)
    hb(h1)
    jobs = [r.submit(ID_CFG, "IdSequence", tenant="t", kernel_source="hand",
                     host=0)["job_id"] for _ in range(6)]
    with open(os.path.join(h0, "service", "heartbeat.jsonl"), "w") as fh:
        fh.write(json.dumps({"kind": "service-heartbeat",
                             "unix": round(time.time() - 60, 3)}) + "\n")
    hb(h1)
    jr = JRouter(r.dir)
    assert r.host_health(0)["state"] == jr.host_health(0)["state"] == "dead"
    out = {}
    barrier = threading.Barrier(2)

    def sweep(name, router):
        barrier.wait()
        out[name] = router.sweep()

    threads = [threading.Thread(target=sweep, args=a) for a in (("t", r), ("j", jr))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    moved = sorted(out["t"]["rerouted"].get(0, []) + out["j"]["rerouted"].get(0, []))
    assert moved == sorted(jobs)
    q0, q1 = JobQueue(h0, create=False), JobQueue(h1, create=False)
    assert q0.pending_count() == 0 and q1.pending_count() == 6
    for jid in jobs:
        spec = json.load(open(q1._job_path("pending", jid)))
        assert [(x["from_host"], x["to_host"], x["reason"]) for x in spec["reroutes"]] == [
            (0, 1, "host-dead")]
        assert [h["why"] for h in r.read_route(jid)["history"]] == ["submit",
                                                                    "reroute:host-dead"]
    assert not [n for n in os.listdir(os.path.join(h0, "queue", "pending"))
                if ".reroute-" in n]
    assert r.sweep()["rerouted"] == {} and jr.sweep()["rerouted"] == {}


@pytest.mark.parametrize("plan", [
    "kill@host0:2,partition@host1:3,skew@host0:-2.5",
    "partition@host0,skew@host1:7,kill@host1:1",
    "skew@host0:1.5,skew@host0:-0.5,crash@daemon0:1",
])
def test_host_fault_plans_scope_as_jax(plan):
    """Each host's view of a composed plan (skew, partition window, kill
    ordinal) equals JAX's, and the plan is wired (check() accepts it)."""
    for host in (0, 1, 2):
        t, j = FaultPlan(plan), JFaultPlan(plan)
        t.set_host(host)
        j.set_host(host)
        assert t.skew_s() == j.skew_s()
        fired = []
        for plan_obj in (t, j):
            try:
                plan_obj.host_kill(1, 2)
                fired.append(None)
            except Exception as e:  # noqa: BLE001
                fired.append(str(e))
        assert fired[0] == fired[1]
        assert (t.host_partition(), t.host_partition()) == (j.host_partition(),
                                                            j.host_partition())
    assert FaultPlan(plan).unwired() == []


def test_host_faults_no_longer_refused_by_check(monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "kill@host0:1,partition@host1,skew@host0:3")
    res = check(tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk",)), device="cpu",
                min_bucket=32)
    assert res.total == 353
    monkeypatch.setenv("KSPEC_FAULT", "skew@host0:3,flip@exchange:2")
    with pytest.raises(ValueError, match="flip@exchange"):
        check(tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk",)), device="cpu",
              min_bucket=32)


def test_injected_skew_reads_the_host_identity(monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "skew@host0:-3,skew@host1:7")
    monkeypatch.setenv("KSPEC_HOST_INSTANCE", "0")
    assert tfaults.injected_skew_s() == -3.0
    monkeypatch.setenv("KSPEC_HOST_INSTANCE", "1")
    assert tfaults.injected_skew_s() == 7.0
    monkeypatch.delenv("KSPEC_HOST_INSTANCE")
    assert tfaults.injected_skew_s() == 0.0
    monkeypatch.setenv("KSPEC_HOST_INSTANCE", "0")
    monkeypatch.delenv("KSPEC_FAULT")
    assert tfaults.injected_skew_s() == 0.0


class VirtualClock(tclock.Clock):
    """A clock that moves only when told to (both packages' clock seam)."""

    def __init__(self, t=1_000_000.0):
        self.t = t
        self.m = 0.0

    def now(self):
        return self.t

    def monotonic(self):
        return self.m

    def sleep(self, seconds):
        self.t += seconds
        self.m += seconds


def test_skew_at_host_on_a_virtual_clock(tmp_path, monkeypatch):
    """skew@host1:-4 on a virtual clock: host 1's lease stamps and daemon
    heartbeats run exactly 4 s behind, in both packages; the router reads
    such a host alive within dead_after + KSPEC_CLOCK_SKEW and dead past
    it, as JAX's does at the same virtual instants."""
    vc = VirtualClock()
    tclock.install(vc)
    jclock.install(vc)
    try:
        monkeypatch.setenv("KSPEC_FAULT", "skew@host1:-4")
        monkeypatch.setenv("KSPEC_HOST_INSTANCE", "1")
        monkeypatch.setenv("KSPEC_CLOCK_SKEW", "5")
        stamps = []
        for qcls, name in ((JobQueue, "t"), (JJobQueue, "j")):
            q = qcls(str(tmp_path / name / "h1"))
            jid = q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"]
            q.claim_pending()
            stamps.append(q.read_lease(jid)["lease_unix"])
        assert stamps == [vc.t - 4.0, vc.t - 4.0]
        d = Daemon(ServeConfig(str(tmp_path / "t" / "h1"), device="cpu", linger_s=0.0))
        d._heartbeat(pending=0)
        rec = json.loads(open(d.heartbeat_path).read().strip().splitlines()[-1])
        assert rec["unix"] == round(vc.t - 4.0, 3)
        monkeypatch.delenv("KSPEC_HOST_INSTANCE")
        states = []
        for rcls, name in ((Router, "t"), (JRouter, "j")):
            h = str(tmp_path / name / "h1")
            r = rcls(str(tmp_path / name / "rt"), hosts=[h], dead_after_s=2.0)
            hb(h, vc.t - 4.0)
            row = [r.host_health(0)["state"]]
            vc.sleep(2.9)  # 6.9 s behind: within 2 + 5
            row.append(r.host_health(0)["state"])
            vc.sleep(0.2)  # 7.1 s: past it
            row.append(r.host_health(0)["state"])
            vc.t -= 3.1
            states.append(row)
        assert states == [["ok", "ok", "dead"]] * 2
    finally:
        tclock.install(None)
        jclock.install(None)


def _partition_drill(tmp_path, daemon_cls, cfg_cls, queue_cls, name, **kw):
    svc = str(tmp_path / name)
    q = queue_cls(svc)
    d = daemon_cls(cfg_cls(service_dir=svc, linger_s=0.0, min_bucket=32, **kw))
    j1 = q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"]
    assert d.drain_once() == 1
    d2 = daemon_cls(cfg_cls(service_dir=svc, linger_s=0.0, min_bucket=32, **kw))
    j2 = q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"]
    assert d2.drain_once() == 1
    r1, r2 = q.result(j1), q.result(j2)
    ev = [(e["event"], e.get("reason"), e.get("republished"), e.get("jobs_degraded"))
          for e in events(svc) if e["event"].startswith("cache-")]
    return (r1["distinct_states"], r1.get("cache"), r2["distinct_states"],
            (r2.get("cache") or {}).get("state_cache")), ev, svc


def test_partition_at_host_degrades_defers_and_heals_as_jax(tmp_path, monkeypatch):
    """partition@host0:1: the first job's lookup is a typed `partition`
    fallback, its publish is deferred and re-published at the heal, the
    marker keeps a restarted daemon out of the window, and the next job is
    a verified hit; the cache events equal the JAX daemon's."""
    monkeypatch.setenv("KSPEC_FAULT", "partition@host0:1")
    monkeypatch.setenv("KSPEC_HOST_INSTANCE", "0")
    t = _partition_drill(tmp_path, Daemon, ServeConfig, JobQueue, "t", device="cpu")
    j = _partition_drill(tmp_path, JDaemon, JServeConfig, JJobQueue, "j")
    assert t[:2] == j[:2]
    assert t[0] == (8, None, 8, "hit")
    kinds = [e[0] for e in t[1]]
    assert kinds[:3] == ["cache-partition-injected", "cache-fallback",
                         "cache-publish-deferred"]
    assert ("cache-fallback", "partition", None, None) in t[1]
    assert ("cache-partition-heal", None, 1, None) in t[1]
    assert os.path.exists(os.path.join(t[2], "service", "faults-fired",
                                       "partition-daemon0"))


def _route_cli(main, root, capsys):
    """The router verbs on one tree; -> [(rc, stdout, last stderr line)]."""
    h0, h1 = str(root / "h0"), str(root / "h1")
    rt = str(root / "rt")
    cfg = root / "id.cfg"
    cfg.write_text(ID_CFG)
    out = []

    def run(*args):
        rc = main(list(args))
        o, e = capsys.readouterr()
        out.append((rc, o, (e.strip().splitlines() or [""])[-1]))
        return o

    run("route", rt, "--hosts", h0, h1, "--dead-after", "2", "--status")
    hb(h0)
    hb(h1)
    sub = json.loads(run("submit", str(cfg), "--module", "IdSequence", "--router", rt,
                         "--json"))
    run("status", sub["job_id"], "--router", rt, "--json")
    run("status", "nope", "--router", rt)
    run("route", rt, "--once")
    with open(os.path.join(rt, "tenants.json"), "w") as fh:
        json.dump({"default": {"max_pending": 1}}, fh)
    run("submit", str(cfg), "--module", "IdSequence", "--router", rt)
    run("result", sub["job_id"], "--router", rt)
    q = JobQueue(sub["service_dir"], create=False)
    q.claim_pending()
    q.finish(sub["job_id"], {"schema": "kspec-verdict/1", "job_id": sub["job_id"],
                             "status": "complete", "exit_code": 0})
    run("result", sub["job_id"], "--router", rt, "--json")
    run("route", str(root / "missing"))
    run("report", rt)
    return out, sub


def _norm(text, root):
    return text.replace(str(root), "<root>")


def test_route_cli_records_text_and_exits_equal_jax(tmp_path, capsys, monkeypatch):
    """`cli route --status/--once`, `submit/status/result --router` and
    `report <router dir>`: the same exit codes and, ids, paths and
    heartbeat ages aside, the same text as JAX's CLI."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t, tsub = _route_cli(cli.main, tmp_path / "t", capsys)
    j, jsub = _route_cli(jcli.main, tmp_path / "j", capsys)
    assert [x[0] for x in t] == [x[0] for x in j] == [0, 0, 0, 1, 0, 2, 2, 0, 2, 0]
    assert tsub["host"] == jsub["host"]

    def scrub(rows, root, sub):
        rows = [(rc, _norm(o, root).replace(sub["job_id"], "<job>"),
                 _norm(e, root).replace(sub["job_id"], "<job>")) for rc, o, e in rows]
        return [(rc, "\n".join(ln.split("heartbeat ")[0] for ln in o.splitlines()), e)
                for rc, o, e in rows]

    ts, js = scrub(t, tmp_path / "t", tsub), scrub(j, tmp_path / "j", jsub)
    for i in (0, 3, 4, 5, 6, 9):
        assert ts[i] == js[i], i
    assert json.loads(t[7][1])["status"] == "complete"
    assert "Router" in t[9][1]
