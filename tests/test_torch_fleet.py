"""PyTorch port: the daemon fleet (service/fleet.py, `cli serve-fleet`)
against the JAX package's, on the CPU.  The lifecycle (death, wedge, rc
75, rc 76, scale-up, graceful drain) runs both packages' FleetManager over
the same torch-free stub daemons, and the fleet events' kinds, instances
and order must be equal.  Then the daemon's fleet identity (the
`instance`/`host` const labels of metrics-<i>.prom, equal to JAX's),
kill@host through the daemon, and `cli serve-fleet` for real: a
crash@daemon0:1 job requeued and finished once by the restarted daemon,
and a fleet without --cpu on a machine with no CUDA ending in the death
taxonomy (never a CPU relaunch).  Every subprocess has a timeout and is
killed in `finally`; the stall timeouts hold on a loaded box (a stub or a
daemon that starts slowly is never read as wedged)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu.service.fleet import FleetManager as JFleetManager
from kafka_specification_tpu.service.fleet import FleetServeConfig as JFleetServeConfig
from kafka_specification_tpu.service.queue import JobQueue as JJobQueue
from kafka_specification_tpu_torch.obs.metrics import MetricsRegistry
from kafka_specification_tpu_torch.resilience.faults import InjectedCrash
from kafka_specification_tpu_torch.service import queue as tqueue
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.service.fleet import FleetManager, FleetServeConfig
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.fleet

REPO = Path(__file__).resolve().parents[1]
IDS = str(REPO / "configs" / "IdSequence.cfg")
ID_CFG = """
SPECIFICATION Spec
CONSTANTS
    MaxId = 6
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""

# the JAX package's stub daemon (tests/test_fleet.py): heartbeats every
# 50 ms, exits on its drain marker, and crashes/wedges/exits typed on cue
_STUB = r"""
import os, sys, time
svc = sys.argv[1]
mode = sys.argv[2] if len(sys.argv) > 2 else "serve"
inst = os.environ["KSPEC_DAEMON_INSTANCE"]
hb = os.path.join(svc, "service", f"heartbeat-{inst}.jsonl")
drain = os.path.join(svc, "service", "drain", inst)
os.makedirs(os.path.dirname(hb), exist_ok=True)
t0 = time.time()
if mode == "exit75":
    sys.exit(75)
while True:
    dt = time.time() - t0
    if mode == "crash" and dt > 0.3:
        sys.exit(3)
    if mode == "exit76" and dt > 0.3:
        sys.exit(76)
    if mode == "wedge" and dt > 0.5:
        time.sleep(3600)
    if os.path.exists(drain):
        sys.exit(0)
    with open(hb, "a") as fh:
        fh.write("tick\n")
    time.sleep(0.05)
"""


def env(**extra):
    e = {**os.environ, "PYTHONPATH": str(REPO)}
    e.pop("KSPEC_FAULT", None)
    e.update(extra)
    return e


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    monkeypatch.delenv("KSPEC_HOST_INSTANCE", raising=False)
    monkeypatch.delenv("KSPEC_DAEMON_INSTANCE", raising=False)


def events(svc, name="fleet-events.jsonl"):
    try:
        with open(os.path.join(svc, "service", name)) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    except OSError:
        return []


def wait(pred, timeout, poll=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return pred()


def stub_fleet(root, manager, config, queue, modes, pending=0, **kw):
    stub = root / "stub_daemon.py"
    stub.write_text(_STUB)
    svc = str(root / "svc")
    q = queue(svc)
    for _ in range(pending):  # stubs never consume: the depth stays
        q.submit(ID_CFG, "IdSequence", kernel_source="hand")

    def command(instance):
        mode = modes[instance] if instance < len(modes) else "serve"
        return [sys.executable, str(stub), svc, mode]

    kw.setdefault("poll_s", 0.05)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.2)
    kw.setdefault("stall_timeout", 30.0)  # a slow stub start is never a wedge
    kw.setdefault("scale_interval_s", 0.2)
    return manager(config(service_dir=svc, command=command, **kw)), svc


#: scenario -> (modes, FleetServeConfig knobs, pending jobs, stop predicate
#: over the fleet events, or None when the fleet ends on its own)
SCENARIOS = {
    "death": (["crash"], dict(daemons=1, min_daemons=1, max_restarts=1), 0, None),
    "wedge": (["wedge"], dict(daemons=1, min_daemons=1, max_restarts=0,
                              stall_timeout=2.0), 0, None),
    "rc75": (["exit75"], dict(daemons=1, min_daemons=1, max_restarts=5), 0, None),
    "rc76": (["exit76"], dict(daemons=1, min_daemons=1, max_restarts=1), 0, None),
    "scale-up": (["serve"] * 3, dict(daemons=1, min_daemons=1, max_daemons=3,
                                     scale_up_pending=2), 8,
                 lambda ev: sum(e["event"] == "daemon-start" for e in ev) >= 3),
    "drain": (["serve", "serve"], dict(daemons=2, min_daemons=1, max_daemons=2,
                                       scale_down_idle_s=0.3), 0,
              lambda ev: any(e["event"] == "fleet-scale-down" for e in ev)),
}


def run_fleet(mgr, svc, stop, timeout=60.0):
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=mgr.run()), daemon=True)
    t.start()
    try:
        if stop is None:
            t.join(timeout=timeout)
        else:
            assert wait(lambda: stop(events(svc)), timeout)
    finally:
        mgr.request_stop()
        t.join(timeout=20)
    assert not t.is_alive()
    return out["rc"], [(e["event"], e.get("instance")) for e in events(svc)]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fleet_lifecycle_events_equal_jax(tmp_path, scenario):
    """Both packages' fleets over the same stubs: the same exit code and the
    same fleet events (kind, instance) in the same order."""
    modes, kw, pending, stop = SCENARIOS[scenario]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tm, tsvc = stub_fleet(tmp_path / "t", FleetManager, FleetServeConfig, tqueue.JobQueue,
                          modes, pending, **kw)
    jm, jsvc = stub_fleet(tmp_path / "j", JFleetManager, JFleetServeConfig, JJobQueue,
                          modes, pending, **kw)
    res = {}
    threads = [threading.Thread(target=lambda k=k, m=m, s=s: res.__setitem__(
        k, run_fleet(m, s, stop))) for k, m, s in (("t", tm, tsvc), ("j", jm, jsvc))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert res["t"] == res["j"], (res["t"], res["j"])
    rc, seq = res["t"]
    kinds = [k for k, _ in seq]
    want = {
        "death": ["daemon-exit", "daemon-restart", "daemon-start", "daemon-exit",
                  "daemon-give-up", "fleet-give-up"],
        "wedge": ["daemon-stall", "daemon-give-up", "fleet-give-up"],
        "rc75": ["daemon-exit", "daemon-resource-exhausted", "fleet-give-up"],
        "rc76": ["daemon-exit", "daemon-integrity-violation", "daemon-restart",
                 "daemon-start", "daemon-exit", "daemon-integrity-violation",
                 "daemon-give-up", "fleet-give-up"],
        "scale-up": ["fleet-scale-up", "daemon-start", "fleet-scale-up", "daemon-start"],
        "drain": ["fleet-drain", "daemon-exit", "fleet-scale-down"],
    }[scenario]
    i = kinds.index("fleet-start") + 1
    assert kinds[i:-1] == want and kinds[-1] == "fleet-stop", kinds
    assert rc == (0 if stop is not None else 1)
    if scenario == "drain":
        exits = [e for e in events(tsvc) if e["event"] == "daemon-exit"]
        assert exits[-1]["instance"] == 1 and exits[-1]["rc"] == 0 and exits[-1]["draining"]


def test_daemon_const_labels_equal_jax(tmp_path, monkeypatch):
    """A fleet daemon's metrics-<i>.prom carries `instance` and `host`
    beside run_id, as the JAX package's does, and the registry's export
    with const labels is JAX's line for line."""
    from kafka_specification_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry

    t = MetricsRegistry(run_id="service-1", const_labels={"instance": "1", "host": "0"})
    j = JMetricsRegistry(run_id="service-1", const_labels={"instance": "1", "host": "0"})
    for reg in (t, j):
        reg.inc("kspec_svc_jobs_total", 2)
        reg.set_gauge("kspec_svc_queue_pending", 3)
    t.write_prom(str(tmp_path / "t.prom"))
    j.write_prom(str(tmp_path / "j.prom"))
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom").read_text()
    assert 'run_id="service-1",host="0",instance="1"' in (tmp_path / "t.prom").read_text()

    monkeypatch.setenv("KSPEC_HOST_INSTANCE", "0")
    d = Daemon(ServeConfig(str(tmp_path / "svc"), device="cpu", instance=1, linger_s=0.0))
    assert d.metrics.const_labels == {"instance": "1", "host": "0"}
    d.metrics.inc("kspec_svc_jobs_total")
    d._export_metrics(jsonl=True)
    prom = (tmp_path / "svc" / "service" / "metrics-1.prom").read_text()
    assert 'run_id="service-1",host="0",instance="1"' in prom
    # the peak device memory gauge is the card's alone
    assert "kspec_svc_device_peak_bytes" not in prom


def test_kill_at_host_fires_once_per_service_dir(tmp_path, monkeypatch):
    """kill@host0:1: host 0's daemon dies before its first job's verdict
    (the claim stays leased), host 1's never; the durable marker lets the
    restarted daemon of host 0 converge and finish the job once."""
    monkeypatch.setenv("KSPEC_FAULT", "kill@host0:1")
    for host in ("1", "0"):
        monkeypatch.setenv("KSPEC_HOST_INSTANCE", host)
        svc = str(tmp_path / f"h{host}")
        q = tqueue.JobQueue(svc)
        job = q.submit(open(IDS).read(), "IdSequence")["job_id"]
        d = Daemon(ServeConfig(svc, device="cpu", min_bucket=32, linger_s=0.0))
        if host == "1":
            assert d.drain_once() == 1 and q.result(job)["distinct_states"] == 12
            continue
        with pytest.raises(InjectedCrash, match="host kill on host 0"):
            d.drain_once()
        assert q.status(job)["state"] == "claimed" and q.result(job) is None
        assert os.path.exists(os.path.join(svc, "service", "faults-fired", "kill-daemon0"))
        monkeypatch.setattr(tqueue, "_PROC_TOKEN", "a-restarted-process")
        d2 = Daemon(ServeConfig(svc, device="cpu", min_bucket=32, linger_s=0.0, max_jobs=1))
        assert d2.serve() == 0 and d2.jobs_done == 1
        assert q.result(job)["distinct_states"] == 12


def _fleet(svc, *args, extra_env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "serve-fleet", svc,
         "--min-bucket", "32", "--poll", "0.2", *args],
        cwd=REPO, env=env(**(extra_env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    proc.communicate()


def test_cli_serve_fleet_crashed_daemon_restarts_and_finishes_once(tmp_path):
    """`cli serve-fleet --cpu` with crash@daemon0:1: daemon 0 dies on the
    job, the fleet restarts the slot, the new daemon requeues the orphaned
    claim and finishes it once; SIGTERM then stops the fleet with exit 0."""
    svc = str(tmp_path / "svc")
    q = tqueue.JobQueue(svc)
    job = q.submit(open(IDS).read(), "IdSequence")["job_id"]
    fleet = _fleet(svc, "--cpu", "--daemons", "1", "--backoff-base", "0.1",
                   "--stall-timeout", "120", extra_env={"KSPEC_FAULT": "crash@daemon0:1"})
    try:
        assert wait(lambda: q.result(job) is not None, timeout=150, poll=0.2)
    finally:
        _stop(fleet)
    assert fleet.returncode == 0
    assert q.result(job)["distinct_states"] == 12
    spec = json.load(open(os.path.join(svc, "queue", "done", f"{job}.json")))
    assert [t["reason"] for t in spec["takeovers"]] == ["dead-pid"]
    kinds = [(e["event"], e.get("instance")) for e in events(svc)]
    assert kinds[:2] == [("daemon-start", 0), ("fleet-start", None)]
    assert ("daemon-exit", 0) in kinds and ("daemon-restart", 0) in kinds
    assert kinds[-1] == ("fleet-stop", None)
    restart = next(e for e in events(svc) if e["event"] == "daemon-restart")
    assert restart["why"] == "crash"


def test_cli_serve_fleet_without_cuda_is_the_death_taxonomy(tmp_path):
    """Without --cpu on a machine with no CUDA each child exits 2 before
    claiming; the parent classifies the deaths, spends the budget and gives
    up (exit 1).  It never relaunches a child on the CPU."""
    assert not torch.cuda.is_available()
    svc = str(tmp_path / "svc")
    q = tqueue.JobQueue(svc)
    job = q.submit(open(IDS).read(), "IdSequence")["job_id"]
    fleet = _fleet(svc, "--daemons", "1", "--max-restarts", "1", "--backoff-base", "0.1",
                   "--stall-timeout", "120", extra_env={"CUDA_VISIBLE_DEVICES": ""})
    try:
        fleet.wait(timeout=120)
    finally:
        _stop(fleet)
    assert fleet.returncode == 1
    ev = events(svc)
    assert [e["event"] for e in ev] == [
        "daemon-start", "fleet-start", "daemon-exit", "daemon-restart", "daemon-start",
        "daemon-exit", "daemon-give-up", "fleet-give-up", "fleet-stop"]
    assert {e["rc"] for e in ev if e["event"] == "daemon-exit"} == {2}
    assert q.status(job)["state"] == "pending"
    logs = sorted(os.listdir(os.path.join(svc, "service", "logs")))
    assert logs == ["daemon0-spawn01.log", "daemon0-spawn02.log"]
    text = open(os.path.join(svc, "service", "logs", logs[0])).read()
    assert "CUDA is not available" in text
