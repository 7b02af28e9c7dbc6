"""PyTorch port: the serving plane's command line on the CPU.  `cli submit`,
`status` and `result` in a process whose torch is poisoned, with the JAX
package's exit codes on the same service directory; `cli serve --cpu
--max-jobs 1` in a subprocess answering `submit --wait --json`; `cli serve`
without --cpu on a machine with no CUDA exiting before it claims a job;
crash@daemon0:1 (the job requeued by the next daemon and finished once) and
stall@daemon0 under `serve --supervised` (the wedged daemon killed, the
restarted one finishing the job).  Every subprocess has a timeout (60 s,
or 120 s for the supervised drill) and is killed in `finally`."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu.utils import cli as jcli
from kafka_specification_tpu_torch.resilience.faults import InjectedCrash
from kafka_specification_tpu_torch.service import queue as tqueue
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.service

REPO = Path(__file__).resolve().parents[1]
IDS = str(REPO / "configs" / "IdSequence.cfg")


def env(**extra):
    e = {**os.environ, "PYTHONPATH": str(REPO), **extra}
    e.pop("KSPEC_FAULT", None)
    e.update(extra)
    return e


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)


def poisoned(svc, calls):
    """Run cli.main(args) for each args in a fresh interpreter whose torch
    cannot be imported; -> [(rc, stdout lines)]."""
    code = textwrap.dedent(
        f"""
        import contextlib, io, json, sys
        sys.modules["torch"] = None
        from kafka_specification_tpu_torch import cli
        out = []
        for args in {calls!r}:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            out.append((rc, buf.getvalue().splitlines()))
        assert "torch" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
        print(json.dumps(out))
        """
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env(), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.splitlines()[-1])


def test_client_verbs_run_with_torch_poisoned_and_exit_as_jax(tmp_path):
    svc = str(tmp_path / "svc")
    d = ["--service-dir", svc]
    (rc_sub, out_sub), (rc_none, _), (rc_router, _) = poisoned(svc, [
        ["submit", IDS, "--json", "--max-depth", "5", *d],
        ["result", "job-none", *d],
        ["submit", IDS, "--router", str(tmp_path / "r")],
    ])
    assert (rc_sub, rc_none, rc_router) == (0, 2, 2)
    job = json.loads(out_sub[-1])["job_id"]
    before = [["status", job, *d], ["status", "job-none", *d], ["status", *d],
              ["result", job, *d]]
    after = [["status", job, "--json", *d], ["result", job, "--json", *d], ["result", job, *d]]
    got = poisoned(svc, before)
    assert [rc for rc, _ in got] == [jcli.main(a) for a in before] == [0, 1, 0, 2]
    assert got[0][1] == [f"{job}: pending"]
    assert Daemon(ServeConfig(svc, device="cpu", min_bucket=32, linger_s=0.0)).drain_once() == 1
    got = poisoned(svc, after)
    assert [rc for rc, _ in got] == [jcli.main(a) for a in after] == [0, 0, 0]
    assert json.loads(got[0][1][-1])["state"] == "done"
    rec = json.loads(got[1][1][-1])
    assert (rec["distinct_states"], rec["exit_code"], rec["status"]) == (6, 0, "complete")
    assert got[2][1][0] == f"Job {job}  [COMPLETE]"


def test_cli_serve_cpu_answers_submit_wait(tmp_path):
    svc = str(tmp_path / "svc")
    serve = subprocess.Popen(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "serve", svc, "--cpu",
         "--max-jobs", "1", "--min-bucket", "32", "--idle-exit", "50"],
        cwd=REPO, env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "submit", IDS,
             "--service-dir", svc, "--wait", "--json", "--timeout", "50"],
            cwd=REPO, env=env(), capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        rec = json.loads(r.stdout.splitlines()[-1])
        assert (rec["distinct_states"], rec["diameter"], rec["exit_code"]) == (12, 11, 0)
        assert serve.wait(timeout=30) == 0
    finally:
        if serve.poll() is None:
            serve.kill()
        serve.communicate()


def test_cli_serve_without_cuda_exits_before_claiming(tmp_path):
    svc = str(tmp_path / "svc")
    job = tqueue.JobQueue(svc).submit(open(IDS).read(), "IdSequence")["job_id"]
    r = subprocess.run(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "serve", svc,
         "--max-jobs", "1"],
        cwd=REPO, env=env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "CUDA is not available" in r.stderr
    assert tqueue.JobQueue(svc).status(job)["state"] == "pending"


def test_crash_at_daemon_requeues_and_finishes_once(tmp_path, monkeypatch):
    """crash@daemon0:1 kills the daemon before its first job's verdict: the
    claim stays leased; the next daemon (a new process: a new claim token)
    requeues it at startup and finishes it, once, without crashing again
    (the fired-marker)."""
    svc = str(tmp_path / "svc")
    q = tqueue.JobQueue(svc)
    job = q.submit(open(IDS).read(), "IdSequence")["job_id"]
    monkeypatch.setenv("KSPEC_FAULT", "crash@daemon0:1")
    with pytest.raises(InjectedCrash):
        Daemon(ServeConfig(svc, device="cpu", min_bucket=32, linger_s=0.0)).drain_once()
    assert q.status(job)["state"] == "claimed" and q.result(job) is None
    monkeypatch.setattr(tqueue, "_PROC_TOKEN", "a-restarted-process")
    d = Daemon(ServeConfig(svc, device="cpu", min_bucket=32, linger_s=0.0, max_jobs=1))
    assert d.serve() == 0 and d.jobs_done == 1
    assert q.status(job)["state"] == "done"
    assert q.result(job)["distinct_states"] == 12
    spec = json.load(open(os.path.join(svc, "queue", "done", f"{job}.json")))
    assert [t["reason"] for t in spec["takeovers"]] == ["dead-pid"]


def test_stall_at_daemon_is_killed_under_serve_supervised(tmp_path):
    """The stall clock starts at the child's spawn, and a daemon's first
    heartbeat comes only after its interpreter has imported torch and the
    engine (~3.4 s on an idle core).  A 4 s timeout therefore stall-killed
    healthy daemons on a loaded box and spent the restart budget.  15 s
    covers a loaded start and is still far below the wedge, which never
    beats again (JAX's own wedge drill allows 8 s)."""
    svc = str(tmp_path / "svc")
    job = tqueue.JobQueue(svc).submit(open(IDS).read(), "IdSequence")["job_id"]
    sup = subprocess.Popen(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "serve", svc, "--cpu",
         "--supervised", "--stall-timeout", "15", "--max-restarts", "2", "--max-jobs", "1",
         "--min-bucket", "32"],
        cwd=REPO, env=env(KSPEC_FAULT="stall@daemon0"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert sup.wait(timeout=120) == 0
    finally:
        if sup.poll() is None:
            sup.kill()
        sup.communicate()
    events = [json.loads(line) for line in open(os.path.join(svc, "service", "events.jsonl"))]
    kinds = [e.get("event") for e in events]
    assert "daemon-wedge-injected" in kinds and "stall-kill" in kinds and "complete" in kinds
    rec = tqueue.JobQueue(svc).result(job)
    assert rec["distinct_states"] == 12 and rec["exit_code"] == 0
