"""PyTorch port: the injectable clock (utils/clock.py), the auto-resume
supervisor (resilience/supervisor.py), the --reclaim sweep
(resources.reclaim_disk), `cli check --resilient` and
scripts/torch_resilient_run.py, against the JAX package's.

Held unit for unit: the clock's surface and pass-through, ``classify_exit``
over the exit codes that matter, and ``reclaim_disk`` on two copies of one
checkpoint directory.  Held run against run: both packages' ``supervise``
over the same scripted children (``python -c`` children with set exit
codes across attempts, one that sleeps without a heartbeat), the event
kinds and fields in order, with the clocks (``ts``, ``unix``, ``seconds``,
``backoff_s``), the command and the directories set aside.  End to end:
``cli check --resilient`` and the standalone runner crash a check at level
4 and resume it to the uninterrupted run's record, and ``cli report`` of
that run directory equals the JAX package's ``render_report``.  Every
child gets ``--cpu``; the installed clock is restored and no child
outlives its test."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kafka_specification_tpu.obs import report as jreport
from kafka_specification_tpu.resilience import resources as jres
from kafka_specification_tpu.resilience import supervisor as jsup
from kafka_specification_tpu.utils import clock as jclock
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch import cli as tcli
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.obs import metrics as tmet
from kafka_specification_tpu_torch.obs import report as treport
from kafka_specification_tpu_torch.obs import tracer as ttracer
from kafka_specification_tpu_torch.resilience import resources as tres
from kafka_specification_tpu_torch.resilience import supervisor as tsup
from kafka_specification_tpu_torch.utils import clock as tclock
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ID_CFG = str(REPO / "configs" / "IdSequence.cfg")
# event fields that read a clock, name a command or a per-side directory
EVENT_VOLATILE = ("ts", "unix", "seconds", "cmd", "backoff_s", "heartbeat", "dirs")
RECORD_KEYS = ("distinct_states", "diameter", "levels", "violation")
# the child: exits with the code of its attempt (the last one repeats),
# counting attempts in a file
CHILD = ("import os, sys; p = sys.argv[1]; n = int(open(p).read()) if os.path.exists(p) "
         "else 0; open(p, 'w').write(str(n + 1)); "
         "codes = [int(c) for c in sys.argv[2].split(',')]; sys.exit(codes[min(n, len(codes) - 1)])")


class FastClock(tclock.SystemClock):
    """Real time, but no sleep longer than 50 ms (a restart's 5 s backoff)."""

    def sleep(self, seconds):
        time.sleep(min(seconds, 0.05))


class VirtualClock(tclock.Clock):
    """Time that only sleeps advance: a poll loop costs no wall time."""

    def __init__(self):
        self.t = 1_000_000.0

    def now(self):
        return self.t

    def monotonic(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds
        time.sleep(0.0005)


@pytest.fixture(autouse=True)
def _restore(tmp_path, monkeypatch):
    """Run directories under tmp_path, no fault plan, the real clock and no
    tracer or registry afterwards."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    yield
    monkeypatch.undo()
    left = tclock.get() is not tclock.SYSTEM
    tclock.install(None)
    jclock.install(None)
    ttracer.set_tracer(None)
    tmet.set_registry(None)
    fault = os.environ.pop("KSPEC_FAULT", None)
    assert not left, "a clock was left installed"
    assert fault is None, f"KSPEC_FAULT left as {fault!r}"


# --- the clock ------------------------------------------------------------------


def test_clock_surface_equals_jax(monkeypatch):
    assert tclock.__all__ == jclock.__all__
    assert tclock.get() is tclock.SYSTEM
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)  # late-bound pass-through
    tclock.sleep(1.5)
    assert slept == [1.5]
    monkeypatch.undo()
    v = VirtualClock()
    assert tclock.install(v) is tclock.SYSTEM
    tclock.sleep(10.0)
    assert (tclock.now(), tclock.monotonic(), tclock.get()) == (1_000_010.0, 1_000_010.0, v)
    assert tclock.install(None) is v and tclock.get() is tclock.SYSTEM
    assert abs(tclock.now() - time.time()) < 1.0
    with pytest.raises(NotImplementedError):
        tclock.Clock().now()


def test_heartbeat_stamps_through_the_clock():
    from kafka_specification_tpu.resilience.heartbeat import heartbeat_record as jhb
    from kafka_specification_tpu_torch.resilience.heartbeat import heartbeat_record as thb

    tclock.install(VirtualClock())
    jclock.install(VirtualClock())
    try:
        assert thb("supervisor", event="start") == jhb("supervisor", event="start")
    finally:
        tclock.install(None)
        jclock.install(None)


# --- the supervisor, unit for unit ---------------------------------------------


@pytest.mark.parametrize("rc", [0, 1, 2, 75, 76, tsup.STALL_RC, -9, 137, None])
def test_classify_exit_equals_jax(rc):
    assert tsup.STALL_RC == jsup.STALL_RC
    assert tsup.classify_exit(rc) == jsup.classify_exit(rc)


def events_of(path, root):
    with open(path) as fh:
        evs = [json.loads(line) for line in fh]
    out = []
    for e in evs:
        e = {k: v for k, v in e.items() if k not in EVENT_VOLATILE}
        out.append(json.loads(json.dumps(e).replace(str(root), "<root>")))
    return out


def supervise_both(tmp_path, codes=None, cmd=None, capsys=None, **cfg):
    """Both packages' supervise() over the same scripted child: -> (port
    rc, events, stderr), (JAX rc, events, stderr), each side's directory
    in its stderr read as <root>."""
    got = []
    for name, mod in (("port", tsup), ("jax", jsup)):
        root = tmp_path / name
        root.mkdir()
        child = cmd or [sys.executable, "-c", CHILD, str(root / "attempts"), codes]
        c = mod.SupervisorConfig(
            cmd=child, events=str(root / "events.jsonl"), log_dir=str(root / "logs"),
            backoff_base=0.01, jitter=0.0, poll=0.02, term_grace=5.0,
            **{k: (v(root) if callable(v) else v) for k, v in cfg.items()})
        rc = mod.supervise(c)
        err = capsys.readouterr().err.replace(str(root), "<root>") if capsys else None
        got.append((rc, events_of(root / "events.jsonl", root), err))
    return got


SCRIPTED = {
    # name: (exit codes by attempt, config, the port's expected rc and kinds)
    "crash then ok": ("3,0", {}, 0,
                      ["start", "exit", "restart", "start", "exit", "complete"]),
    "exit 1 restarts to give-up": ("1", {"max_restarts": 1}, 1,
                                   ["start", "exit", "restart", "start", "exit", "give-up"]),
    "exit 75 halts": ("75", {}, 75,
                      ["start", "exit", "resource-exhausted", "resource-verdict"]),
    "exit 75 reclaims once": ("75", {"reclaim": True, "reclaim_dirs": lambda r: (str(r),)}, 75,
                              ["start", "exit", "resource-exhausted", "reclaim", "start",
                               "exit", "resource-exhausted", "resource-verdict"]),
    "exit 75 then ok after reclaim": ("75,0", {"reclaim": True}, 0,
                                      ["start", "exit", "resource-exhausted", "reclaim",
                                       "start", "exit", "complete"]),
    "exit 76 restarts": ("76,0", {}, 0,
                         ["start", "exit", "integrity-violation", "restart", "start", "exit",
                          "complete"]),
    "crashes exhaust the budget": ("9", {"max_restarts": 2}, 9,
                                   ["start", "exit", "restart"] * 2 + ["start", "exit",
                                                                      "give-up"]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTED))
def test_supervise_equals_jax_on_scripted_children(name, tmp_path, capsys):
    codes, cfg, want_rc, kinds = SCRIPTED[name]
    capsys.readouterr()
    (t_rc, t_ev, t_err), (j_rc, j_ev, j_err) = supervise_both(
        tmp_path, codes, capsys=capsys, run_id="r1", **cfg)
    assert t_rc == j_rc == want_rc
    assert [e["event"] for e in t_ev] == kinds
    assert t_ev == j_ev
    assert all(e["kind"] == "supervisor" and e["run_id"] == "r1" for e in t_ev)
    assert t_err == j_err  # the verdict and give-up lines


def test_stall_kill_to_give_up_equals_jax(tmp_path):
    """A child that sleeps without heartbeating is stall-killed (its whole
    process group), restarted once, stall-killed again, given up on."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(600)"]
    t0 = time.monotonic()
    (t_rc, t_ev, _), (j_rc, j_ev, _) = supervise_both(
        tmp_path, cmd=sleeper, heartbeat=lambda r: str(r / "never.jsonl"),
        stall_timeout=0.3, max_restarts=1)
    assert time.monotonic() - t0 < 30
    assert t_rc == j_rc == tsup.STALL_RC
    kinds = [e["event"] for e in t_ev]
    assert kinds == ["start", "stall-kill", "exit", "restart", "start", "stall-kill", "exit",
                     "give-up"]
    assert t_ev == j_ev


def test_stall_in_virtual_time(tmp_path):
    """The clock seam: the default 1800 s stall timeout passes in virtual
    time while the child has slept a moment of real time."""
    tclock.install(VirtualClock())
    t0 = time.monotonic()
    c = tsup.SupervisorConfig(
        cmd=[sys.executable, "-c", "import time; time.sleep(600)"],
        heartbeat=str(tmp_path / "never.jsonl"), events=str(tmp_path / "ev.jsonl"),
        max_restarts=0, term_grace=5.0)
    try:
        assert tsup.supervise(c) == tsup.STALL_RC
    finally:
        tclock.install(None)
    assert time.monotonic() - t0 < 60
    evs = [json.loads(line) for line in open(tmp_path / "ev.jsonl")]
    assert [e["event"] for e in evs] == ["start", "stall-kill", "exit", "give-up"]
    assert evs[2]["seconds"] > 1800


def test_reclaim_disk_equals_jax(tmp_path):
    """On two copies of one checkpoint directory (three generations, a
    spill subdirectory, stale tmp files) both sweeps remove the same
    files, and the newest generation survives."""
    src = tmp_path / "src"
    check(tfrl.make_model(2, 2, 2), device="cpu", min_bucket=32, checkpoint_dir=str(src),
          checkpoint_keep=3, mem_budget=64)
    (src / "bfs_checkpoint.npz.tmp.123").write_bytes(b"x")
    (src / "spill").mkdir(exist_ok=True)
    (src / "spill" / "run-7.bin.tmp").write_bytes(b"y")
    (src / "spill" / "notes.txt").write_text("kept")
    before = sorted(str(p.relative_to(src)) for p in src.rglob("*") if p.is_file())
    assert "bfs_checkpoint.1.npz" in before and "bfs_checkpoint.2.npz" in before
    removed = []
    for name, mod in (("port", tres), ("jax", jres)):
        d = tmp_path / name
        shutil.copytree(src, d)
        removed.append(sorted(str(Path(p).relative_to(d)) for p in mod.reclaim_disk([str(d)])))
        assert (d / "bfs_checkpoint.npz").exists()
    assert removed[0] == removed[1]
    assert {"bfs_checkpoint.1.npz", "bfs_checkpoint.2.npz", "bfs_checkpoint.npz.tmp.123",
            "spill/run-7.bin.tmp"} <= set(removed[0])
    after = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())  # noqa
    assert after(tmp_path / "port") == after(tmp_path / "jax")
    assert tres.reclaim_disk([None, str(tmp_path / "absent")]) == []


# --- end to end -------------------------------------------------------------------


def cli_json(argv, capsys):
    rc = tcli.main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out.splitlines()[-1])


def last_record(log_dir):
    for name in sorted(os.listdir(log_dir), reverse=True):
        with open(os.path.join(log_dir, name), errors="replace") as fh:
            for line in reversed(fh.read().splitlines()):
                if line.startswith("{"):
                    return json.loads(line)
    return None


@pytest.fixture(scope="module")
def plain_record(tmp_path_factory):
    d = tmp_path_factory.mktemp("plain")
    argv = ["check", ID_CFG, "--cpu", "--json", "--run-dir", str(d / "run")]
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(argv) == 0
    ttracer.set_tracer(None)
    tmet.set_registry(None)
    return json.loads(out.getvalue().splitlines()[-1])


def test_cli_check_resilient_resumes_a_crash(tmp_path, plain_record, capsys):
    """cli check --resilient --checkpoint D --fault crash@level:4: two
    starts, a restart and complete; the last attempt's record is the
    uninterrupted run's; cli report names the restart and equals JAX's."""
    run = tmp_path / "run"
    tclock.install(FastClock())
    try:
        rc = tcli.main(["check", ID_CFG, "--cpu", "--json", "--resilient", "--checkpoint",
                        str(tmp_path / "ck"), "--fault", "crash@level:4", "--run-dir",
                        str(run), "--max-restarts", "2"])
    finally:
        tclock.install(None)
        os.environ.pop("KSPEC_FAULT", None)  # --fault exported it, as JAX's CLI does
    assert rc == 0
    evs = [json.loads(line) for line in open(run / "events.jsonl")]
    assert [e["event"] for e in evs] == ["start", "exit", "restart", "start", "exit",
                                         "complete"]
    assert all(e["kind"] == "supervisor" for e in evs)
    assert evs[1]["rc"] not in (0, 75, 76)
    cmd = evs[0]["cmd"]
    assert cmd[1:3] == ["-m", "kafka_specification_tpu_torch.cli"]
    assert "--resilient" not in cmd and cmd[-2:] == ["--stats", str(run / "stats.jsonl")]
    final = last_record(run / "logs")
    assert {k: final[k] for k in RECORD_KEYS} == {k: plain_record[k] for k in RECORD_KEYS}
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["config"]["supervised"] is True and final["run_id"] == manifest["run_id"]
    capsys.readouterr()
    assert tcli.main(["report", str(run)]) == 0
    text = capsys.readouterr().out
    assert "restarts=1" in text
    later = time.time() + 10_000
    assert treport.render_report(str(run), now=later) == jreport.render_report(
        str(run), now=later)


def test_resilient_flags_and_prefix_stripped(tmp_path, monkeypatch):
    """The child argv loses --resilient and its abbreviations; without
    --checkpoint the warning is JAX's; the supervisor's config is built
    from the flags."""
    seen = {}

    def fake_supervise(cfg):
        seen["cfg"] = cfg
        return 0

    monkeypatch.setattr(tsup, "supervise", fake_supervise)
    args = ["check", ID_CFG, "--cpu", "--resil", "--stall-timeout", "12", "--max-restarts",
            "3", "--events", str(tmp_path / "ev.jsonl"), "--reclaim", "--spill-dir",
            str(tmp_path / "sp"), "--run-dir", str(tmp_path / "run")]
    assert tcli.main(args) == 0
    cfg = seen["cfg"]
    assert "--resil" not in cfg.cmd and cfg.cmd[3:5] == ["check", ID_CFG]
    assert (cfg.stall_timeout, cfg.max_restarts, cfg.reclaim) == (12.0, 3, True)
    assert cfg.events == str(tmp_path / "ev.jsonl")
    assert cfg.reclaim_dirs == (str(tmp_path / "sp"),)
    assert cfg.log_dir == str(tmp_path / "run" / "logs")
    assert cfg.heartbeat == str(tmp_path / "run" / "stats.jsonl")


def test_standalone_runner_resumes_a_crash(tmp_path, plain_record):
    """scripts/torch_resilient_run.py around `cli check --checkpoint`
    with KSPEC_FAULT=crash@level:4: the same events and final record."""
    hb, ev, logs = tmp_path / "hb.jsonl", tmp_path / "events.jsonl", tmp_path / "logs"
    env = dict(os.environ, KSPEC_FAULT="crash@level:4")
    rc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_resilient_run.py"), "--run-dir",
         str(tmp_path / "run"), "--heartbeat", str(hb), "--events", str(ev), "--log-dir",
         str(logs), "--stall-timeout", "300", "--max-restarts", "3", "--backoff", "0.05", "--",
         sys.executable, "-m", "kafka_specification_tpu_torch.cli", "check", ID_CFG, "--cpu",
         "--json", "--checkpoint", str(tmp_path / "ck"), "--stats", str(hb)],
        cwd=REPO, env=env, timeout=300, capture_output=True, text=True,
    ).returncode
    assert rc == 0
    kinds = [json.loads(line)["event"] for line in open(ev)]
    assert kinds == ["start", "exit", "restart", "start", "exit", "complete"]
    final = last_record(logs)
    assert {k: final[k] for k in RECORD_KEYS} == {k: plain_record[k] for k in RECORD_KEYS}
