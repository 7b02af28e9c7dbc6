"""PyTorch port: the sharded engine's storage legs (parallel/sharded.py)
against the JAX package's check_sharded, with zero tolerance: the disk
tier (one TieredFpSet a shard under <spill>/shard<d>, forced spills and
merges), its checkpoints (run manifests and hot dumps, resumed on the
same mesh and elastically, written by either package and resumed by the
other) and the resource governor (typed exits of the fault matrix, a
breached disk budget, a soft breach's reclaim).  The cases of JAX's
tests/test_storage.py and tests/test_resources.py at their knobs (the
forced-spill shapes KSPEC_SPILL_SEG_ROWS=13, KSPEC_SPILL_RUNS_PER_MERGE=2;
D = 8 is their default mesh); spill files and spill counts are compared
with both packages' overlap layer off (with it on, thread timing decides
when a background merge is adopted)."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.resilience.faults import FaultPlan as JFaultPlan
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.resilience.faults import FaultPlan, InjectedCrash
from kafka_specification_tpu_torch.resilience.resources import ResourceExhausted
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.spill

THW = "KafkaTruncateToHighWatermark"
WEAK = ("TypeOk", "WeakIsr")
BASE = "sharded_checkpoint.npz"
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement", "shard_new", "shard_frontier", "shard_enabled",
                 "shard_duplicates")
SPILL_KEYS = ("hot", "disk", "runs", "spills", "merges")


@pytest.fixture(autouse=True)
def _tiny_spill_shapes(monkeypatch):
    """Spills, segment cuts and merges at toy state counts (JAX's tests'
    scheme)."""
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def records(path):
    with open(path) as fh:
        return [{k: r[k] for k in DETERMINISTIC} for r in map(json.loads, fh)]


class ChainSpy:
    """The last chain object that sealed a level, in either package."""

    def __init__(self, monkeypatch):
        self.last = None
        for cls in (jinteg.LevelDigestChain, tinteg.LevelDigestChain):
            real = cls.seal

            def seal(chain, depth, count, real=real):
                self.last = chain
                return real(chain, depth, count)

            monkeypatch.setattr(cls, "seal", seal)


def tiny_models():
    return (lambda: jkip320.make_model(JConfig(2, 2, 1, 1), ("TypeOk",)),
            lambda: tkip320.make_model(Config(2, 2, 1, 1), ("TypeOk",)))


def thw_models():
    return (lambda: jvariants.make_model(THW, JConfig(2, 2, 1, 1), WEAK),
            lambda: tvariants.make_model(THW, Config(2, 2, 1, 1), WEAK))


_JAX: dict = {}


def jax_golden(key, tmp_path_factory, monkeypatch):
    """The JAX package's in-RAM host run at D = 8 (once per module): its
    result, stats records and chain."""
    if key not in _JAX:
        jm, _ = {"tiny": tiny_models, "thw": thw_models}[key]()
        spy = ChainSpy(monkeypatch)
        path = str(tmp_path_factory.mktemp("jax") / "stats.jsonl")
        res = jsharded.check_sharded(jm(), mesh=jax_mesh(8), min_bucket=32,
                                     visited_backend="host", stats_path=path,
                                     **({"store_trace": False} if key == "tiny" else {}))
        _JAX[key] = (res, records(path), spy.last.to_array())
    return _JAX[key]


def spill_counts(res):
    return [None if s is None else {k: s[k] for k in SPILL_KEYS} for s in res.stats["spill"]]


def test_forced_spill_bit_identical_sharded(monkeypatch, tmp_path, tmp_path_factory):
    """JAX's case: Kip320 TINY through per-shard runs at a 2 KB budget, on
    the port's tier with the layer off and on: JAX's levels, stats records
    (duplicates per shard included) and chain, spills on the disk, every
    fingerprint once; with both layers off, every shard's spill and merge
    counts and its run files byte for byte are the JAX package's."""
    jgold, jstats, jchain = jax_golden("tiny", tmp_path_factory, monkeypatch)
    assert jgold.ok and jgold.total == 277
    jm, tm = tiny_models()
    monkeypatch.setenv("KSPEC_OVERLAP", "0")
    jsd = str(tmp_path / "jspill")
    jtier = jsharded.check_sharded(jm(), mesh=jax_mesh(8), min_bucket=32, mem_budget=2048,
                                   spill_dir=jsd, store_trace=False)
    for overlap in ("0", "1"):
        monkeypatch.setenv("KSPEC_OVERLAP", overlap)
        sd = str(tmp_path / f"spill{overlap}")
        spy = ChainSpy(monkeypatch)
        path = str(tmp_path / f"stats{overlap}.jsonl")
        res = check_sharded(tm(), mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=2048,
                            spill_dir=sd, store_trace=False, stats_path=path)
        assert verdict(res) == verdict(jgold) == verdict(jtier)
        assert records(path) == jstats and np.array_equal(spy.last.to_array(), jchain)
        spilled = [s for s in res.stats["spill"] if s]
        assert sum(x["spills"] for x in spilled) > 0
        assert sum(x["disk"] + x["hot"] for x in spilled) == 277
        assert res.stats["host_fpset_sizes"] == jgold.stats["host_fpset_sizes"]
        if overlap == "0":
            assert spill_counts(res) == spill_counts(jtier)
            for d in range(8):
                names = sorted(os.listdir(os.path.join(jsd, f"shard{d}")))
                assert sorted(os.listdir(os.path.join(sd, f"shard{d}"))) == names
                for n in names:
                    with open(os.path.join(sd, f"shard{d}", n), "rb") as a, open(
                            os.path.join(jsd, f"shard{d}", n), "rb") as b:
                        assert a.read() == b.read(), (d, n)


def test_forced_spill_sharded_violating_variant_trace(monkeypatch, tmp_path, tmp_path_factory):
    """JAX's case: the violating variant on the tier gives the in-RAM host
    path's verdict and every value of its trace, with JAX's stats records
    and chain."""
    jgold, jstats, jchain = jax_golden("thw", tmp_path_factory, monkeypatch)
    assert jgold.violation is not None and jgold.violation.depth == 8
    _, tm = thw_models()
    spy = ChainSpy(monkeypatch)
    path = str(tmp_path / "stats.jsonl")
    res = check_sharded(tm(), mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=2048,
                        spill_dir=str(tmp_path / "sd"), stats_path=path)
    assert verdict(res) == verdict(jgold)
    assert res.violation.trace == jgold.violation.trace
    assert records(path) == jstats and np.array_equal(spy.last.to_array(), jchain)


def test_sharded_disk_crash_resume_exact(monkeypatch, tmp_path):
    """JAX's case: crash@level:2 on the tier at D = 8, resumed from the
    checkpointed run manifests to JAX's result."""
    golden = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(8), min_bucket=32,
                                    store_trace=False, visited_backend="host")
    ck = str(tmp_path / "sck")
    kw = dict(mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=512, checkpoint_dir=ck)
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:2")
    with pytest.raises(InjectedCrash):
        check_sharded(tfrl.make_model(2, 2, 2), **kw)
    monkeypatch.delenv("KSPEC_FAULT")
    resumed = check_sharded(tfrl.make_model(2, 2, 2), **kw)
    assert verdict(resumed) == verdict(golden)
    assert resumed.stats["host_fpset_sizes"] == golden.stats["host_fpset_sizes"]


def test_ephemeral_spill_directory_is_removed(tmp_path):
    """No spill_dir and no checkpoint: the tier spills under a temporary
    directory, removed after the completed run."""
    res = check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32,
                        mem_budget=64)
    assert res.ok and res.total == 49 and sum(s["spills"] for s in res.stats["spill"]) > 0
    assert not os.path.exists(res.stats["spill_dir"])


def _tier_cut(engine, model, mesh, ck):
    """A checkpointed tier run cut at depth 4 (a generation a level)."""
    return engine(model, mesh=mesh, min_bucket=64, mem_budget=256, checkpoint_dir=ck,
                  max_depth=4)


def test_tier_checkpoints_cross_between_the_packages(monkeypatch, tmp_path):
    """The violating model on the tier at D = 4, cut at depth 4 with a
    checkpoint every level (layers off): the port's directory is the JAX
    package's, main member for member (the run manifests, the hot dumps)
    and run file for run file; each package's cut resumed by the other on
    the same mesh and elastically at D = 2, to the fault-free result with
    every trace value (the parent log of the other package read back)."""
    monkeypatch.setenv("KSPEC_OVERLAP", "0")
    jm, tm = thw_models()
    golden = jsharded.check_sharded(jm(), mesh=jax_mesh(4), min_bucket=64)
    assert golden.violation is not None
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    _tier_cut(jsharded.check_sharded, jm(), jax_mesh(4), jck)
    _tier_cut(check_sharded, tm(), ShardMesh(4, "cpu"), tck)
    for gen in ("", ".1", ".2"):
        name = BASE.replace(".npz", f"{gen}.npz")
        a = tckpt.verify_file(os.path.join(tck, name))
        b = jckpt.verify_file(os.path.join(jck, name))
        assert list(a) == list(b)
        for k in a:
            if k in ("host_hot",):
                continue
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (gen, k)
        # each shard's hot dump equal as a set
        sa = np.split(np.asarray(a["host_hot"]), np.cumsum(a["host_hot_lens"])[:-1])
        sb = np.split(np.asarray(b["host_hot"]), np.cumsum(b["host_hot_lens"])[:-1])
        assert all(np.array_equal(np.sort(x), np.sort(y)) for x, y in zip(sa, sb))
    for d in range(4):
        for n in sorted(os.listdir(os.path.join(jck, "spill", f"shard{d}"))):
            with open(os.path.join(tck, "spill", f"shard{d}", n), "rb") as fa, open(
                    os.path.join(jck, "spill", f"shard{d}", n), "rb") as fb:
                assert fa.read() == fb.read(), (d, n)
    monkeypatch.delenv("KSPEC_OVERLAP")
    for src, engine, model, mesh in (
            (jck, check_sharded, tm, ShardMesh), (tck, jsharded.check_sharded, jm, None)):
        for D in (4, 2):
            ck = str(tmp_path / f"resume-{os.path.basename(src)}-{D}")
            shutil.copytree(src, ck)
            m = mesh(D, "cpu") if mesh is not None else jax_mesh(D)
            res = engine(model(), mesh=m, min_bucket=64, mem_budget=256, checkpoint_dir=ck)
            assert verdict(res) == verdict(golden), (src, D)
            assert res.violation.trace == golden.violation.trace, (src, D)


# --- the resource governor ------------------------------------------------------


def test_resource_faults_respect_resume_depth_and_shard_scope():
    """JAX's unit case, on both packages' plans alike."""
    for FP in (FaultPlan, JFaultPlan):
        p = FP("enospc@ckpt:2,stall@level:3")
        p.set_start_depth(5)  # resumed past both targets: counts as fired
        p.enospc("ckpt", 2)
        assert not p.stalled(3)
        p2 = FP("enospc@shard1:spill:1")
        p2.set_local_shards([0])  # shard 1 lives elsewhere: never local
        p2.enospc("spill", 1)
        p2.set_local_shards([1])
        with pytest.raises(OSError):
            p2.enospc("spill", 1)


@pytest.mark.parametrize("fault,reason", [
    ("enospc@shard0:spill:2", "enospc"),  # shard-scoped resource fault
    ("enospc@ckpt:3", "enospc"),
    ("enospc@plog:4", "enospc"),
    ("stall@level:4", "stall"),
])
def test_resource_fault_matrix_sharded(fault, reason, monkeypatch, tmp_path, tmp_path_factory):
    """JAX's sharded drill: the fault stops the tier run at D = 8 with JAX's
    typed exit and reason, the checkpoint verifies offline (in both
    packages), and the resume reaches JAX's verdict with every trace value
    from the init state on."""
    golden, _, jchain = jax_golden("thw", tmp_path_factory, monkeypatch)
    _, tm = thw_models()
    ck = str(tmp_path / "ck")
    kw = dict(mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=2048, checkpoint_dir=ck)
    monkeypatch.setenv("KSPEC_FAULT", fault)
    with pytest.raises(ResourceExhausted) as ei:
        check_sharded(tm(), **kw)
    monkeypatch.delenv("KSPEC_FAULT")
    assert ei.value.reason == reason
    rep = tckpt.verify_checkpoint_dir(ck)
    assert rep["ok"] and rep == jckpt.verify_checkpoint_dir(ck), rep
    resumed = check_sharded(tm(), **kw)
    assert verdict(resumed) == verdict(golden)
    assert resumed.violation.trace == golden.violation.trace
    assert resumed.violation.trace[0][0] == "<init>"
    assert np.array_equal(tckpt.verify_file(os.path.join(ck, BASE))["digest_chain"], jchain)


def test_disk_budget_hard_breach_checkpoints_then_resumes(monkeypatch, tmp_path,
                                                         tmp_path_factory):
    """A real breach: a 1-byte disk budget trips at the first level
    boundary, the forced final save makes the level resumable, and the
    resume with the budget lifted reaches JAX's result."""
    golden, _, _ = jax_golden("thw", tmp_path_factory, monkeypatch)
    _, tm = thw_models()
    ck = str(tmp_path / "ck")
    kw = dict(mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=2048, checkpoint_dir=ck)
    with pytest.raises(ResourceExhausted) as ei:
        check_sharded(tm(), disk_budget=1, **kw)
    assert ei.value.reason == "disk" and ei.value.at_boundary
    assert tckpt.verify_checkpoint_dir(ck)["ok"]
    resumed = check_sharded(tm(), **kw)
    assert verdict(resumed) == verdict(golden)
    assert resumed.violation.trace == golden.violation.trace


def test_soft_breach_reclaims_and_run_completes(monkeypatch, tmp_path, tmp_path_factory):
    """Every level a soft breach under a roomy budget (KSPEC_RESOURCE_SOFT=0):
    the engine reclaims each level (each shard's merge worker quiesced, its
    tmp files swept, its runs merged, a fresh checkpoint, the older
    generations pruned, the deletion barriers flushed) and still reaches
    JAX's result, with only the newest generation left."""
    golden, _, jchain = jax_golden("thw", tmp_path_factory, monkeypatch)
    _, tm = thw_models()
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_RESOURCE_SOFT", "0")
    spy = ChainSpy(monkeypatch)
    res = check_sharded(tm(), mesh=ShardMesh(8, "cpu"), min_bucket=32, mem_budget=2048,
                        checkpoint_dir=ck, disk_budget="64M")
    assert verdict(res) == verdict(golden) and res.violation.trace == golden.violation.trace
    assert np.array_equal(spy.last.to_array(), jchain)
    assert [n for n in os.listdir(ck) if n.endswith(".npz")] == [BASE]
    assert tckpt.verify_checkpoint_dir(ck)["ok"]


def test_cli_sharded_tier_under_a_run_context(monkeypatch, tmp_path, capsys):
    """`cli check --sharded --mem-budget --run-dir`: exit 0 with the JAX
    package's counts, and the run directory's metrics carry one spill gauge
    a shard (JAX's observer's labels), as the manifest's result does the
    record."""
    from kafka_specification_tpu_torch import cli

    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    run = tmp_path / "run"
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "IdSequence.cfg")
    rc = cli.main(["check", cfg, "--sharded", "--cpu", "--json", "--mem-budget", "64",
                   "--checkpoint", str(tmp_path / "ck"), "--run-dir", str(run)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["distinct_states"] == 12
    prom = (run / "metrics.prom").read_text()
    assert 'kspec_spill_spills{shard="0"' in prom and 'kspec_spill_runs{shard="0"' in prom
    man = json.loads((run / "manifest.json").read_text())
    assert man["status"] == "complete" and man["result"]["distinct_states"] == 12
