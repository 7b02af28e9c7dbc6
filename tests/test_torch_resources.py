"""PyTorch port: the resource governor (resilience/resources.py), fault
injection (resilience/faults.py) and the offline checkpoint verifier against
the JAX package's, with zero tolerance: the fault grammar parsed token for
token as JAX parses it, unwired sites refused by name; the governor's soft
reclaim, hard exit, level deadline and RSS budget; every wired resource
fault ending in ResourceExhausted with a checkpoint both packages' verifiers
pass and an exact resume (verdict, trace, chain); every bit flip caught as
JAX catches it; and `cli check --json` exit 75 and `cli verify-checkpoint`
printing the JAX CLI's record and report."""

import json
import os

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import faults as jfaults
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.resilience import resources as jres
from kafka_specification_tpu_torch import check, cli
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import faults as tfaults
from kafka_specification_tpu_torch.resilience import resources as tres
from kafka_specification_tpu_torch.resilience.integrity import IntegrityError
from kafka_specification_tpu_torch.storage.atomic import atomic_write
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.resource

THW = "KafkaTruncateToHighWatermark"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRL_CFG = os.path.join(REPO, "configs", "FiniteReplicatedLog.cfg")


@pytest.fixture(autouse=True)
def _tiny_spill_shapes(monkeypatch):
    """The JAX package's forced-spill fixture (every disk write path runs)."""
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    monkeypatch.delenv("KSPEC_FAULT", raising=False)


@pytest.fixture(autouse=True)
def _runs_root(tmp_path, monkeypatch):
    """Each CLI check's run directory lands under this test's tmp_path."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))


def tthw():
    return tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk", "WeakIsr"))


def jthw():
    return jvariants.make_model(THW, JConfig(2, 2, 1, 1), ("TypeOk", "WeakIsr"))


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def chain_of(ckpt_dir):
    return tckpt.verify_file(os.path.join(ckpt_dir, CHECKPOINT_BASENAME))["digest_chain"]


_GOLD: dict = {}


def golden():
    """The JAX package's in-RAM host run of the trace model, and the port's
    uninterrupted disk-tier run's chain (held equal to JAX's below)."""
    if not _GOLD:
        _GOLD["jax"] = jbfs.check(jthw(), min_bucket=32, visited_backend="host")
    return _GOLD["jax"]


# --- the grammar ------------------------------------------------------------

TOKENS = [
    "crash@level:7", "crash@ckpt:3", "crash@merge:2", "corrupt_ckpt", "corrupt_ckpt@ckpt:4",
    "compile_oom", "transient_device_err:3", "enospc@spill:2", "enospc@merge:1",
    "enospc@ckpt:3", "enospc@plog:4", "enospc@cache:1", "stall@level:5", "flip@frontier:3",
    "flip@fpset:5", "flip@exchange:4", "flip@spill:1", "flip@ckpt:2", "flip@cache:2",
    "crash@shard2:level:4", "corrupt_ckpt@shard1", "corrupt_ckpt@shard1:ckpt:3",
    "transient_device_err@shard0:2", "compile_oom@shard0", "enospc@shard1:spill:2",
    "crash@daemon1:3", "stall@daemon0", "kill@host1:2", "partition@host0", "partition@host0:3",
    "skew@host2:-1.5",
]
BAD = ["crash@lvl:3", "enospc@frontier:1", "stall@ckpt:1", "enospc@spill", "stall@level:0",
       "bogus", "crash@shardx:level:2", "skew@host1:0", "crash@daemon0:0", "kill@host1:x",
       "corrupt_ckpt:3", "flip@frntier:2", "crash@level:x"]


def spec_fields(s):
    return (s.kind, s.point, s.arg, s.budget, s.shard, s.instance, s.host)


@pytest.mark.parametrize("tok", TOKENS)
def test_grammar_parses_as_jax(tok):
    t, j = tfaults.FaultPlan(tok), jfaults.FaultPlan(tok)
    assert [spec_fields(s) for s in t.specs] == [spec_fields(s) for s in j.specs]


@pytest.mark.parametrize("tok", BAD)
def test_grammar_refuses_what_jax_refuses(tok):
    with pytest.raises(ValueError):
        jfaults.FaultPlan(tok)
    with pytest.raises(ValueError):
        tfaults.FaultPlan(tok)


def test_hooks_fire_as_jax_hooks_fire():
    plan = ("enospc@spill:2,enospc@merge:1,enospc@ckpt:3,enospc@plog:4,stall@level:5,"
            "enospc@shard1:spill:2,crash@level:3,crash@merge:2,flip@frontier:3,flip@spill:1,"
            "corrupt_ckpt@ckpt:4")
    calls = [("enospc", "spill", 2), ("enospc", "spill", 2), ("enospc", "spill", 2),
             ("enospc", "merge", 2), ("enospc", "merge", 1), ("stalled", 4), ("stalled", 5),
             ("stalled", 5), ("crash", "level", 2), ("crash", "level", 3, 2),
             ("crash", "level", 4), ("crash", "merge", 1), ("crash", "merge", 2),
             ("flip", "frontier", 2), ("flip", "frontier", 4), ("flip", "spill", 2),
             ("flip", "spill", 1), ("corrupt", 3), ("corrupt", 4), ("corrupt", 4)]
    outcomes = []
    for mod in (tfaults, jfaults):
        p, out = mod.FaultPlan(plan), []
        for c in calls:
            try:
                if c[0] == "stalled":
                    out.append(p.stalled(c[1]))
                elif c[0] == "corrupt":
                    out.append(p.should_corrupt(c[1]))
                elif c[0] == "flip":
                    out.append(bool(p.flip(c[1], c[2])))
                elif c[0] == "crash":
                    p.crash(c[1], c[2], *c[3:])
                    out.append(None)
                else:
                    p.enospc(c[1], c[2])
                    out.append(None)
            except OSError as e:
                out.append(("ENOSPC", e.errno, tres.is_disk_full(e)))
            except mod.InjectedCrash as e:
                out.append(("crash", str(e)))
        outcomes.append(out)
    assert outcomes[0] == outcomes[1]
    relief = [tfaults.FaultPlan("enospc@ckpt:2,stall@level:3,crash@level:2"),
              jfaults.FaultPlan("enospc@ckpt:2,stall@level:3,crash@level:2")]
    for p in relief:
        p.set_start_depth(5)
        p.enospc("ckpt", 2)
        p.crash("level", 6)
        assert not p.stalled(3)


def test_unwired_sites_are_named():
    assert tfaults.FaultPlan(",".join(TOKENS[:5] + TOKENS[7:11] + TOKENS[12:15]
                                      + TOKENS[16:18])).unwired() == []
    assert tfaults.FaultPlan("compile_oom,flip@exchange:2,kill@host1:2").unwired() == [
        "compile_oom", "flip@exchange", "kill@host"]


# --- the governor -----------------------------------------------------------


def test_parse_bytes_dir_usage_and_rss(tmp_path):
    for text in ("1.5K", 4096, "512M", "4G"):
        assert tres.parse_bytes(text) == jres.parse_bytes(text)
    with pytest.raises(ValueError):
        tres.parse_bytes("-1G")
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    (sub / "x").write_bytes(b"\x00" * 100)
    (tmp_path / "y").write_bytes(b"\x00" * 50)
    assert tres.dir_usage_bytes([str(tmp_path), str(sub)]) == 150
    assert tres.dir_usage_bytes([str(tmp_path / "missing")]) == 0
    assert tres.rss_bytes() is None or tres.rss_bytes() > 0
    assert tres.EXIT_RESOURCE_EXHAUSTED == jres.EXIT_RESOURCE_EXHAUSTED == 75


def test_governor_soft_breach_reclaims_then_hard_exits(tmp_path):
    d = tmp_path / "spill"
    d.mkdir()
    (d / "junk").write_bytes(b"\x00" * 900)
    gov = tres.ResourceGovernor(disk_budget=1000, soft_frac=0.5, watch_dirs=[str(d)])
    calls = []

    def reclaim():
        calls.append(1)
        (d / "junk").write_bytes(b"\x00" * 100)

    gov.level_end(3, reclaim=reclaim)
    assert calls == [1] and gov.reclaims == 1 and gov.pressure_events == 1
    (d / "junk").write_bytes(b"\x00" * 2000)
    saved = []
    with pytest.raises(tres.ResourceExhausted) as ei:
        gov.level_end(4, reclaim=lambda: None, save_hook=lambda: saved.append(1))
    assert ei.value.reason == "disk" and ei.value.at_boundary and saved == [1]
    assert gov.stats() == {"disk_budget": 1000, "rss_budget": None, "level_deadline": None,
                           "reclaims": 2, "pressure_events": 2}


def test_governor_deadline_rss_and_env(monkeypatch):
    gov = tres.ResourceGovernor(level_deadline=0.0)
    gov.level_begin(7)
    with pytest.raises(tres.ResourceExhausted) as ei:
        gov.poll(7)
    assert ei.value.reason == "deadline"
    with pytest.raises(tres.ResourceExhausted) as ei:
        tres.ResourceGovernor(rss_budget=1).level_end(2)
    assert ei.value.reason == "rss"
    monkeypatch.setenv("KSPEC_DISK_BUDGET", "2M")
    monkeypatch.setenv("KSPEC_RSS_BUDGET", "64G")
    monkeypatch.setenv("KSPEC_LEVEL_DEADLINE", "30")
    monkeypatch.setenv("KSPEC_RESOURCE_SOFT", "0.5")
    t, j = tres.ResourceGovernor.from_env(), jres.ResourceGovernor.from_env()
    assert t.stats() == j.stats() and t.soft_frac == j.soft_frac == 0.5


def test_atomic_write_cleans_its_tmp(tmp_path):
    p = str(tmp_path / "out.bin")

    def boom(fh):
        fh.write(b"partial")
        raise OSError(28, "No space left on device")

    with pytest.raises(OSError):
        atomic_write(p, boom)
    assert os.listdir(str(tmp_path)) == []
    atomic_write(p, lambda fh: fh.write(b"ok"))
    assert os.listdir(str(tmp_path)) == ["out.bin"]
    with open(p, "rb") as fh:
        assert fh.read() == b"ok"


# --- the engine: every resource fault, a typed exit and an exact resume ------


def drill(fault, tmp_path, monkeypatch, budget=300):
    """Inject `fault`, require ResourceExhausted, verify the checkpoint with
    both packages' verifiers, resume with the fault cleared, and hold the
    result to JAX's trace and the JAX package's chain under the same fault.
    Both packages run their serial paths (overlap=False): with the overlap
    layer on, a fault raised on a worker surfaces at the next join, and
    thread timing may decide at which level."""
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", fault)
    with pytest.raises(tres.ResourceExhausted) as ei:
        check(tthw(), min_bucket=32, mem_budget=budget, checkpoint_dir=ck, overlap=False,
              device="cpu")
    with pytest.raises(jres.ResourceExhausted) as ej:
        jbfs.check(jthw(), min_bucket=32, mem_budget=budget, checkpoint_dir=jck, overlap=False)
    monkeypatch.delenv("KSPEC_FAULT")
    assert (ei.value.reason, ei.value.depth) == (ej.value.reason, ej.value.depth)
    rep = tckpt.verify_checkpoint_dir(ck)
    assert rep["ok"], rep
    assert jckpt.verify_checkpoint_dir(ck)["ok"]
    assert sorted(os.listdir(ck)) == sorted(os.listdir(jck))
    t = check(tthw(), min_bucket=32, mem_budget=budget, checkpoint_dir=ck, overlap=False,
              device="cpu")
    j = jbfs.check(jthw(), min_bucket=32, mem_budget=budget, checkpoint_dir=jck, overlap=False)
    g = golden()
    assert verdict(t) == verdict(j) == verdict(g)
    assert t.violation.trace == g.violation.trace and t.violation.trace[0][0] == "<init>"
    assert np.array_equal(chain_of(ck), chain_of(jck))
    return ei.value


@pytest.mark.fault
@pytest.mark.parametrize("fault,reason", [
    ("enospc@spill:2", "enospc"), ("enospc@merge:1", "enospc"), ("enospc@ckpt:3", "enospc"),
    ("enospc@plog:4", "enospc"), ("stall@level:4", "stall"),
])
def test_resource_fault_matrix(fault, reason, tmp_path, monkeypatch):
    assert drill(fault, tmp_path, monkeypatch).reason == reason


def test_disk_budget_hard_breach_checkpoints_then_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(tres.ResourceExhausted) as ei:
        check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, disk_budget=1,
              device="cpu")
    assert ei.value.reason == "disk" and ei.value.at_boundary and ei.value.depth == 1
    assert tckpt.verify_checkpoint_dir(ck)["ok"]
    t = check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu")
    assert verdict(t) == verdict(golden()) and t.violation.trace == golden().violation.trace


def test_soft_breach_reclaims_every_level_and_completes(tmp_path, monkeypatch):
    """KSPEC_RESOURCE_SOFT=0: every level is a soft breach, so the run
    reclaims (janitor, eager merge, fresh checkpoint, prune, flush) every
    level and still finishes exact, with one generation left."""
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_RESOURCE_SOFT", "0")
    t = check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, disk_budget="64M",
              device="cpu")
    assert verdict(t) == verdict(golden()) and t.violation.trace == golden().violation.trace
    assert [n for n in os.listdir(ck) if n.endswith(".npz")] == [CHECKPOINT_BASENAME]
    assert t.stats["governor"]["reclaims"] == 8 == t.stats["governor"]["pressure_events"]
    assert tckpt.verify_checkpoint_dir(ck)["ok"]


def test_level_deadline_exits_typed_and_resumes(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_LEVEL_DEADLINE", "0")
    with pytest.raises(tres.ResourceExhausted) as ei:
        check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu")
    assert ei.value.reason == "deadline"
    monkeypatch.delenv("KSPEC_LEVEL_DEADLINE")
    t = check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu")
    assert verdict(t) == verdict(golden()) and t.violation.trace == golden().violation.trace


# --- bit flips and corrupt checkpoints: caught as JAX catches them ----------


@pytest.mark.fault
@pytest.mark.parametrize("site,backend,disk", [
    ("frontier", "device", False), ("fpset", "device", False), ("fpset", "host", False),
    ("fpset", "device-hash", False), ("ckpt", "device", False), ("frontier", "host", True),
    ("spill", "host", True), ("ckpt", "host", True),
])
def test_flip_caught_as_jax_catches_it_and_recovered(site, backend, disk, tmp_path, monkeypatch):
    n = 1 if site == "spill" else 2
    kw = dict(min_bucket=32, visited_backend=backend)
    if disk:
        kw.update(mem_budget=256, store="disk")
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", f"flip@{site}:{n}")
    with pytest.raises(IntegrityError) as ei:
        check(tfrl.make_model(2, 2, 2), checkpoint_dir=ck, overlap=False, device="cpu", **kw)
    with pytest.raises(jinteg.IntegrityError) as ej:
        jbfs.check(jfrl.make_model(2, 2, 2), checkpoint_dir=jck, overlap=False, **kw)
    monkeypatch.delenv("KSPEC_FAULT")
    assert (ei.value.site, ei.value.depth) == (ej.value.site, ej.value.depth)
    assert tckpt.verify_checkpoint_dir(ck)["ok"] == jckpt.verify_checkpoint_dir(jck)["ok"]
    resumed = check(tfrl.make_model(2, 2, 2), checkpoint_dir=ck, device="cpu", **kw)
    assert resumed.ok and (resumed.total, resumed.levels) == (49, [1, 4, 12, 16, 16])


def test_corrupt_checkpoint_falls_back_as_jax_does(tmp_path, monkeypatch, capsys):
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", "corrupt_ckpt@ckpt:3")
    t_cut = check(tfrl.make_model(2, 2, 2), min_bucket=32, checkpoint_dir=ck, max_depth=3,
                  device="cpu")
    jbfs.check(jfrl.make_model(2, 2, 2), min_bucket=32, checkpoint_dir=jck, max_depth=3)
    monkeypatch.delenv("KSPEC_FAULT")
    rep, jrep = tckpt.verify_checkpoint_dir(ck), jckpt.verify_checkpoint_dir(jck)
    assert [g["ok"] for g in rep["stores"][0]["generations"]] == \
        [g["ok"] for g in jrep["stores"][0]["generations"]] == [False, True, True]
    res = check(tfrl.make_model(2, 2, 2), min_bucket=32, checkpoint_dir=ck, device="cpu")
    assert "resuming from generation 1 (level 2)" in capsys.readouterr().err
    assert res.ok and res.total == 49 and t_cut.levels == res.levels[:4]


# --- the CLI ----------------------------------------------------------------


def jax_cli(argv, capsys):
    from kafka_specification_tpu.utils.cli import main as jmain

    try:
        rc = jmain(argv)
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    return rc, capsys.readouterr()


def port_cli(argv, capsys):
    try:
        rc = cli.main(argv)
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    return rc, capsys.readouterr()


def record(out):
    rec = json.loads(out.strip().splitlines()[-1])
    return {k: v for k, v in rec.items() if k not in ("seconds", "states_per_sec", "run_id")}


def test_cli_exit_75_and_verify_checkpoint_equal_jax(tmp_path, capsys):
    """`cli check --fault enospc@spill:1 --json` exits 75 with the JAX CLI's
    record and advice; `cli verify-checkpoint` prints the JAX CLI's report
    (JSON and text) on the port's directory; the same command without the
    fault resumes to exit 0; a --disk-budget below the run's spill exits 75
    the same way."""
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    common = [FRL_CFG, "--min-bucket", "32", "--mem-budget", "300", "--json"]
    rc, out = port_cli(["check", *common, "--cpu", "--checkpoint", ck,
                        "--fault", "enospc@spill:1"], capsys)
    jrc, jout = jax_cli(["check", *common, "--cpu", "--hand", "--checkpoint", jck,
                         "--run-dir", str(tmp_path / "run"), "--fault", "enospc@spill:1"],
                        capsys)
    assert rc == jrc == 75
    assert record(out.out) == record(jout.out)
    assert record(out.out)["exit_code"] == 75
    assert "RESOURCE EXHAUSTED" in out.err and f"verify-checkpoint {ck}" in out.err
    assert "KSPEC_FAULT" not in os.environ
    for argv in (["verify-checkpoint", ck, "--json"], ["verify-checkpoint", ck]):
        rc, out = port_cli(argv, capsys)
        jrc, jout = jax_cli(argv, capsys)
        assert rc == jrc == 0
        assert out.out == jout.out
    rc, out = port_cli(["check", *common, "--cpu", "--checkpoint", ck], capsys)
    assert rc == 0 and record(out.out)["distinct_states"] == 29791
    ck2, jck2 = str(tmp_path / "ck2"), str(tmp_path / "jck2")
    rc, out = port_cli(["check", *common, "--cpu", "--checkpoint", ck2, "--disk-budget", "1"],
                       capsys)
    jrc, jout = jax_cli(["check", *common, "--cpu", "--hand", "--checkpoint", jck2,
                         "--run-dir", str(tmp_path / "run2"), "--disk-budget", "1"], capsys)
    assert rc == jrc == 75
    assert record(out.out) == record(jout.out)
    assert record(out.out)["error"].startswith("RESOURCE_EXHAUSTED[disk]: ")


def test_cli_verify_checkpoint_reports_a_broken_directory(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, max_depth=4, device="cpu")
    runs = os.path.join(ck, "spill", "fps")
    for name in os.listdir(runs):
        if name.endswith(".fps"):
            os.unlink(os.path.join(runs, name))
    for argv in (["verify-checkpoint", ck, "--json"], ["verify-checkpoint", ck]):
        rc, out = port_cli(argv, capsys)
        jrc, jout = jax_cli(argv, capsys)
        assert rc == jrc == 1 and out.out == jout.out
    assert "missing run file" in out.out
    rc, out = port_cli(["verify-checkpoint", str(tmp_path / "nothing"), "--json"], capsys)
    assert rc == 1 and json.loads(out.out)["error"] == "not a directory"
