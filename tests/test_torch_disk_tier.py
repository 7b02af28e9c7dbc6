"""PyTorch port: check() on the disk tier (mem_budget/spill_dir/store) against
the JAX package's, with zero tolerance, at the JAX package's forced-spill
fixture (segments of 13 rows, a merge every 2 runs, a 300-byte budget):
levels, total, diameter, verdict, trace values, digest chain and the
stats["spill"] counts, on the legacy, fused and device pipelines and after a
crash and resume; the spill directory and the checkpoint's spill_manifest
byte for byte (the serial paths of both packages, overlap=False: with the
overlap layer on, thread timing decides when a background merge is
adopted); and disk-tier checkpoints resumed across the two packages.

Trace values are held against the in-RAM `host` run: the tier spills the
host level of the hierarchy, and which parent a state keeps is a property
of the backend."""

import os

import numpy as np
import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.resilience.checkpoints import verify_file
from kafka_specification_tpu_torch.resilience.faults import FaultPlan, InjectedCrash
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.spill

KIP_INV = ("TypeOk", "LeaderInIsr", "WeakIsr", "StrongIsr")
THW = "KafkaTruncateToHighWatermark"
# the device pipeline's knobs in the JAX package's tests (every level on the card)
DEV_KW = dict(chunk_size=256, compact_gate=32)


@pytest.fixture(autouse=True)
def _tiny_spill_shapes(monkeypatch):
    """The JAX package's forced-spill fixture: segment cuts and merges at
    toy state counts, so every disk code path runs."""
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    monkeypatch.delenv("KSPEC_FAULT", raising=False)


def jthw():
    return jvariants.make_model(THW, JConfig(2, 2, 1, 1), ("TypeOk", "WeakIsr"))


def tthw():
    return tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk", "WeakIsr"))


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def same(t, j):
    """The port's result equals the JAX package's: verdict and trace."""
    assert verdict(t) == verdict(j)
    if j.violation is not None:
        assert t.violation.trace == j.violation.trace
        assert t.violation.state == j.violation.state


def tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def chain_of(ckpt_dir):
    return verify_file(os.path.join(str(ckpt_dir), CHECKPOINT_BASENAME))["digest_chain"]


_GOLD: dict = {}


def golden(key):
    """The JAX package's runs, once per module: its in-RAM `host` runs (the
    trace reference) and its disk-tier runs on the serial path."""
    if key not in _GOLD:
        if key == "thw-host":
            _GOLD[key] = jbfs.check(jthw(), min_bucket=32, visited_backend="host")
        elif key == "thw-host-dev":
            _GOLD[key] = jbfs.check(jthw(), min_bucket=32, visited_backend="host", **DEV_KW)
        elif key == "kip-disk":
            _GOLD[key] = jbfs.check(jkip320.make_model(JConfig(2, 2, 1, 1), KIP_INV),
                                    min_bucket=32, mem_budget=300, overlap=False)
        else:
            raise KeyError(key)
    return _GOLD[key]


# --- forced spills, every pipeline ------------------------------------------


def test_kip320_tiny_forced_spills_equal_jax():
    """Kip320 2r L2 R1 E1, all four invariants: 277 states through spills
    and merges, stats["spill"] equal to the JAX package's, key for key."""
    j = golden("kip-disk")
    t = check(tkip320.make_model(Config(2, 2, 1, 1), KIP_INV), min_bucket=32, mem_budget=300,
              overlap=False, device="cpu")
    assert t.ok and t.total == 277
    same(t, j)
    assert t.stats["spill"] == j.stats["spill"]
    assert t.stats["spill"]["spills"] > 0 and t.stats["spill"]["merges"] > 0
    assert t.stats["spill"]["disk"] + t.stats["spill"]["hot"] == 277
    assert t.stats["visited_backend"] == "host" == j.stats["visited_backend"]
    assert (t.stats["mem_budget"], t.stats["host_fpset_size"]) == (300, 277)
    assert t.stats["visited_capacity"] == j.stats["visited_capacity"]
    # the temporary spill directory is gone after a completed run
    assert t.stats["spill_dir"].split(os.sep)[-1].startswith("kspec-spill-")
    assert not os.path.exists(t.stats["spill_dir"])


@pytest.mark.parametrize("pipeline", ["legacy", "fused", "device"])
def test_violating_variant_trace_on_every_pipeline(pipeline, tmp_path):
    """TruncateToHW 2r violates WeakIsr at depth 8: the trace from the
    on-disk parent log equals the JAX package's in-RAM host trace, value for
    value, on all three pipelines (the device pipeline at the JAX package's
    device knobs, every level on the card, one batched insert a level)."""
    kw = DEV_KW if pipeline == "device" else {}
    j = golden("thw-host-dev" if pipeline == "device" else "thw-host")
    t = check(tthw(), min_bucket=32, mem_budget=300, spill_dir=str(tmp_path), pipeline=pipeline,
              device="cpu", **kw)
    same(t, j)
    assert len(t.violation.trace) == 9 and t.violation.trace[0][0] == "<init>"
    assert t.stats["spill"]["spills"] > 0
    if pipeline == "device":
        assert t.stats["device"]["fallback"] is None and t.stats["device"]["levels"] > 0


def test_device_pipeline_on_the_tier_equals_jax_tier(tmp_path):
    """The JAX package's own device pipeline on its disk tier (serial
    path): the same verdict, trace, spill counts and spill files."""
    j = jbfs.check(jthw(), min_bucket=32, mem_budget=300, spill_dir=str(tmp_path / "j"),
                   pipeline="device", overlap=False, **DEV_KW)
    t = check(tthw(), min_bucket=32, mem_budget=300, spill_dir=str(tmp_path / "t"),
              pipeline="device", overlap=False, device="cpu", **DEV_KW)
    same(t, j)
    assert t.stats["spill"] == j.stats["spill"]
    assert t.stats["device"] == j.stats["device"]
    assert tree(tmp_path / "t") == tree(tmp_path / "j")


def test_store_disk_without_budget_uses_the_default(tmp_path):
    res = check(tfrl.make_model(2, 2, 2), min_bucket=32, store="disk",
                spill_dir=str(tmp_path / "t"), device="cpu")
    j = jbfs.check(jfrl.make_model(2, 2, 2), min_bucket=32, store="disk",
                   spill_dir=str(tmp_path / "j"), overlap=False)
    assert res.ok and res.total == 49 == j.total
    assert res.stats["spill"]["spills"] == 0 and res.stats["mem_budget"] == 4 << 30
    assert res.stats["spill"] == j.stats["spill"]
    assert check(tfrl.make_model(2, 2, 2), min_bucket=32, store="ram", mem_budget="1K",
                 device="cpu").stats.get("spill") is None


# --- crash and resume -------------------------------------------------------


@pytest.mark.fault
def test_merge_crash_resumes_exactly(tmp_path, monkeypatch):
    """crash@merge:1 dies after the merged tmp write, before its promote;
    the resume lands the uninterrupted verdict and trace."""
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_FAULT", "crash@merge:1")
    with pytest.raises(InjectedCrash):
        check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu")
    monkeypatch.delenv("KSPEC_FAULT")
    same(check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu"),
         golden("thw-host"))


@pytest.mark.fault
def test_level_crash_then_violation_reports_the_full_trace(tmp_path, monkeypatch):
    """crash@level:4 then resume: the violation found after the resume
    reports the full trace, read from the parent log, and the chain equals
    the JAX package's run through the same crash."""
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:4")
    with pytest.raises(InjectedCrash):
        check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, overlap=False,
              device="cpu")
    with pytest.raises(Exception, match="injected crash at level:4"):
        jbfs.check(jthw(), min_bucket=32, mem_budget=300, checkpoint_dir=jck, overlap=False)
    assert int(verify_file(os.path.join(ck, CHECKPOINT_BASENAME))["depth"]) == 4
    monkeypatch.delenv("KSPEC_FAULT")
    t = check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, overlap=False,
              device="cpu")
    j = jbfs.check(jthw(), min_bucket=32, mem_budget=300, checkpoint_dir=jck, overlap=False)
    same(t, golden("thw-host"))
    same(t, j)
    assert t.violation.trace and t.violation.trace[0][0] == "<init>"
    assert np.array_equal(chain_of(ck), chain_of(jck))
    assert tree(os.path.join(ck, "spill")) == tree(os.path.join(jck, "spill"))


@pytest.mark.fault
def test_dot_prefixed_spill_dir_honors_the_deletion_barrier(tmp_path, monkeypatch):
    """A './'-relative checkpoint directory, crashed twice and resumed,
    merges forced throughout: the barrier's path comparisons still hold."""
    monkeypatch.chdir(tmp_path)
    ck = os.path.join(".", "ck")
    for fault in ("crash@level:3", "crash@level:6"):
        monkeypatch.setenv("KSPEC_FAULT", fault)
        with pytest.raises(InjectedCrash):
            check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu")
    monkeypatch.delenv("KSPEC_FAULT")
    same(check(tthw(), min_bucket=32, mem_budget=300, checkpoint_dir=ck, device="cpu"),
         golden("thw-host"))


# --- the files, and checkpoints across packages -----------------------------


def test_spill_files_and_manifest_equal_jax_and_resume_across_packages(tmp_path):
    """Cut at depth 5 with a checkpoint every level: the spill directories
    and the checkpoints (spill_manifest, hot dump, chain) of the two
    packages are equal byte for byte; then each package resumes the
    other's checkpoint to the JAX verdict and trace."""
    kw = dict(min_bucket=32, mem_budget=300, max_depth=5)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    t_cut = check(tthw(), checkpoint_dir=tdir, overlap=False, device="cpu", **kw)
    j_cut = jbfs.check(jthw(), checkpoint_dir=jdir, overlap=False, **kw)
    assert verdict(t_cut) == verdict(j_cut)
    assert tree(os.path.join(tdir, "spill")) == tree(os.path.join(jdir, "spill"))
    ta = verify_file(os.path.join(tdir, CHECKPOINT_BASENAME))
    ja = verify_file(os.path.join(jdir, CHECKPOINT_BASENAME))
    assert sorted(ta) == sorted(ja)
    for k in ta:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    assert str(ta["spill_manifest"]) == str(ja["spill_manifest"])
    assert str(ta["ident"]).endswith("|store=disk")
    assert ckpt_files(tdir) == ckpt_files(jdir)  # member order and bytes
    kw.pop("max_depth")
    t = check(tthw(), checkpoint_dir=jdir, device="cpu", **kw)  # the port resumes JAX's
    j = jbfs.check(jthw(), checkpoint_dir=tdir, **kw)  # JAX (its default) resumes the port's
    same(t, golden("thw-host"))
    same(j, golden("thw-host"))
    assert np.array_equal(chain_of(tdir), chain_of(jdir))


def ckpt_files(ckpt_dir) -> dict:
    """Every checkpoint generation's file, name -> bytes."""
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith("bfs_checkpoint") and name.endswith(".npz"):
            with open(os.path.join(ckpt_dir, name), "rb") as fh:
                out[name] = fh.read()
    return out


@pytest.mark.parametrize("overlap", [False, True], ids=["overlap-off", "overlap-on"])
def test_tier_checkpoint_files_equal_jax_byte_for_byte(tmp_path, monkeypatch, overlap):
    """The tier's checkpoint generations are the JAX package's files byte
    for byte (members in its order: spill_manifest, host_fps, vcap, levels,
    total, then the chain stamp), with the overlap layer's async writer and
    without.  No merge runs here (a background merge's adoption time would
    change the manifest), and a fault plan that never fires is armed, under
    which both engines join the writer at every level start: the deletion
    barrier, which the manifest records, then advances at the same points."""
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "1000")
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:99")
    kw = dict(min_bucket=32, mem_budget=300, max_depth=6, overlap=overlap)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    t = check(tthw(), checkpoint_dir=tdir, device="cpu", **kw)
    j = jbfs.check(jthw(), checkpoint_dir=jdir, **kw)
    assert verdict(t) == verdict(j)
    tf, jf = ckpt_files(tdir), ckpt_files(jdir)
    assert len(jf) == 3 and sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name


def test_unwired_fault_sites_are_refused(monkeypatch):
    for plan in ("flip@exchange:3", "flip@exchange:1", "flip@shard0:exchange:2",
                 "crash@level:3,flip@exchange:2", "compile_oom,flip@exchange:3",
                 "transient_device_err:2,flip@exchange:4", "partition@host0,flip@exchange:5"):
        monkeypatch.setenv("KSPEC_FAULT", plan)
        bad = FaultPlan(plan).unwired()
        assert bad
        with pytest.raises(ValueError, match="not wired") as ei:
            check(tthw(), min_bucket=32, device="cpu")
        for site in bad:
            assert site in str(ei.value)


def test_a_spill_directory_that_cannot_be_made_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        check(tthw(), min_bucket=32, mem_budget=300, spill_dir=str(blocker / "spill"),
              device="cpu")


def test_the_tier_needs_no_card_tensor_for_a_level(tmp_path, monkeypatch):
    """The per-chunk path reads a spilled frontier a chunk at a time: no
    tensor handed to the chunk stage holds more than one chunk's rows."""
    from kafka_specification_tpu_torch.engine import bfs as tbfs

    widest = []
    real = tbfs.run_chunk

    def spy(model, piece, *a, **k):
        widest.append(piece.shape[0])
        assert isinstance(piece, torch.Tensor)
        return real(model, piece, *a, **k)

    monkeypatch.setattr(tbfs, "run_chunk", spy)
    res = check(tthw(), min_bucket=32, chunk_size=32, mem_budget=300, spill_dir=str(tmp_path),
                device="cpu")
    assert max(widest) == 32 and max(res.levels) > 32
