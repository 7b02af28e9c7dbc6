"""PyTorch port: checkpoints (resilience/checkpoints.py, durable_io.py, and
check()'s checkpoint_dir) against the JAX package's, with zero tolerance:
the manifest, rotation, pruning and the fallback past a corrupt newest
generation; the identity string byte for byte for every ported .cfg
(AsyncIsr and the Stretch product included); a checkpoint written by
either package resumed by the other, per visited backend, to the
uninterrupted run's levels and chain (and for AsyncIsr 2r); a CRC-consistent
corrupt frontier caught by the chain on resume; and the empty trace of a
violation found after a resume."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models.base import Invariant as JInvariant
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu_torch import check, durable_io
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME, checkpoint_ident
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models.base import Invariant as TInvariant
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.utils import cfg as tcfg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
BACKENDS = ["device", "device-hash", "host"]
KW = dict(min_bucket=32, chunk_size=256, compact_gate=32)
_MODELS: dict = {}


def kip320_pair():
    """Kip320 2r L2 R1 E1: 277 states, diameter 12."""
    if not _MODELS:
        _MODELS["kip"] = (jkip320.make_model(jkr.Config(2, 2, 1, 1)),
                          tkip320.make_model(tkr.Config(2, 2, 1, 1)))
    return _MODELS["kip"]


def arrays_at(depth):
    return {"frontier": np.arange(6, dtype=np.uint32).reshape(3, 2) + depth,
            "levels": np.arange(depth + 1), "total": depth * 10}


# --- the store ------------------------------------------------------------


def test_manifest_and_files_equal_jax(tmp_path):
    arrays = dict(arrays_at(3), ident="x", depth=3,
                  host_fps=np.array([0, 2**63, 2**64 - 1], np.uint64))
    assert tckpt.build_manifest(arrays) == jckpt.build_manifest(arrays)
    port = tckpt.CheckpointStore(str(tmp_path / "p"), "c.npz", ident="id")
    jax_ = jckpt.CheckpointStore(str(tmp_path / "j"), "c.npz", ident="id")
    p, j = port.save(3, arrays_at(3)), jax_.save(3, arrays_at(3))
    for reader in (tckpt.verify_file, jckpt.verify_file):
        a, b = reader(p), reader(j)
        assert sorted(a) == sorted(b) == ["depth", "frontier", "ident", "levels", "total"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # one flipped byte fails the checksum
    raw = bytearray(Path(p).read_bytes())
    i = raw.index(np.arange(6, dtype=np.uint32).tobytes()[4:8])
    raw[i] ^= 1
    Path(p).write_bytes(bytes(raw))
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.verify_file(p)


def test_rotation_prune_and_fallback(tmp_path, capsys):
    store = tckpt.CheckpointStore(str(tmp_path), "c.npz", ident="id", keep=3)
    assert store.load() is None
    for depth in range(1, 6):
        store.save(depth, arrays_at(depth))
    assert store.generations() == [0, 1, 2]
    assert [int(tckpt.verify_file(store.path(g))["depth"]) for g in (0, 1, 2)] == [5, 4, 3]
    arrays, parts, gen = store.load()
    assert gen == 0 and int(arrays["depth"]) == 5 and parts == {}

    # a torn newest generation: the next one that verifies, said on stderr
    Path(store.path(0)).write_bytes(Path(store.path(0)).read_bytes()[:100])
    arrays, parts, gen = store.load()
    assert gen == 1 and int(arrays["depth"]) == 4
    assert "resuming from generation 1 (level 4)" in capsys.readouterr().err

    # content that fails a validator (its checksums pass): skipped as well
    bad = tckpt.CheckpointStore(str(tmp_path), "c.npz", ident="id", keep=3,
                                validators=(lambda a: ["odd"] if int(a["depth"]) == 4 else [],))
    arrays, parts, gen = bad.load()
    assert gen == 2 and int(arrays["depth"]) == 3

    # every generation corrupt: no silent fresh start
    for g in (1, 2):
        Path(store.path(g)).write_bytes(b"junk")
    with pytest.raises(tckpt.CheckpointCorrupt, match="no checkpoint generation verified"):
        store.load()

    store.save(6, arrays_at(6))
    store.save(7, arrays_at(7))
    removed = store.prune(keep_gens=1)
    assert sorted(map(os.path.basename, removed)) == ["c.1.npz", "c.2.npz"]
    assert store.generations() == [0]


def test_identity_mismatch_and_tmp_janitor(tmp_path):
    store = tckpt.CheckpointStore(str(tmp_path), "c.npz", ident="model A")
    store.save(1, arrays_at(1))
    with pytest.raises(ValueError, match="different model/config"):
        tckpt.CheckpointStore(str(tmp_path), "c.npz", ident="model B").load()
    stray = tmp_path / "c.npz.tmp.npz"
    stray.write_bytes(b"half")
    other = tmp_path / "notes.tmp"
    other.write_text("not ours")
    tckpt.CheckpointStore(str(tmp_path), "c.npz", ident="model A")
    assert not stray.exists() and other.exists()
    with pytest.raises(ValueError, match=".npz"):
        tckpt.CheckpointStore(str(tmp_path), "c.bin", ident="x")


def test_durable_io(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    durable_io.write_text(a, "one\n", fsync=True)
    durable_io.append_text(a, "two\n")
    assert Path(a).read_text() == "one\ntwo\n"
    durable_io.replace(a, b)
    assert not Path(a).exists() and Path(b).read_text() == "one\ntwo\n"
    durable_io.fsync_dir(str(tmp_path))
    durable_io.unlink(b)
    assert not Path(b).exists()
    for name in ("x.tmp", "y.123.tmp", "z.tmp.npz", "keep.npz"):
        (tmp_path / name).write_text("")
    removed = durable_io.sweep_tmp(str(tmp_path))
    assert sorted(map(os.path.basename, removed)) == ["x.tmp", "y.123.tmp", "z.tmp.npz"]
    (tmp_path / "young.tmp").write_text("")
    assert durable_io.sweep_tmp(str(tmp_path), min_age_s=3600) == []
    assert durable_io.sweep_tmp(str(tmp_path / "missing")) == []


# --- check() --------------------------------------------------------------


def jax_ident(model, backend, check_invariants, check_deadlock):
    """The JAX engine's identity stamp (kafka_specification_tpu/engine/
    bfs.py, check(): `ckpt_ident`), from the JAX model."""
    spec = model.spec
    inv_names = ",".join(sorted(i.name for i in model.invariants)) if check_invariants else "-"
    return (
        f"{model.name}|lanes={spec.num_lanes}|backend={backend}|"
        f"inv={inv_names}|dl={check_deadlock}|"
        + ",".join(f"{f.name}:{f.shape}:{f.lo}:{f.hi}" for f in spec.fields)
    )


@pytest.mark.parametrize("name", ["IdSequence", "FiniteReplicatedLog",
                                  "KafkaTruncateToHighWatermark", "Kip101", "Kip279", "Kip320",
                                  "Kip320FirstTry", "AsyncIsr", "Kip320Stretch"])
def test_identity_string_byte_for_byte(name):
    path = REPO / "configs" / f"{name}.cfg"
    module = {"Kip320Stretch": "Kip320"}.get(name, name)  # the 5r x 3 product
    jm = jcfg.build_model(module, jcfg.parse_cfg(path), analysis_gate=False)
    tm = tcfg.build_model(module, tcfg.parse_cfg(path))
    for backend in BACKENDS:
        for inv in (True, False):
            for dl in (True, False):
                assert checkpoint_ident(tm, backend, inv, dl) == jax_ident(jm, backend, inv, dl)
    assert all(type(f.shape) is tuple and all(type(n) is int for n in f.shape)
               for f in tm.spec.fields)


def _newest(directory):
    return tckpt.verify_file(os.path.join(directory, CHECKPOINT_BASENAME))


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_isr_resume_across_packages(backend, tmp_path):
    """AsyncIsr 2r M2 V2 (84 states, diameter 11): JAX writes up to depth
    5 and the port resumes, and the other way round."""
    from kafka_specification_tpu.models import async_isr as jasync
    from kafka_specification_tpu_torch.models import async_isr as tasync

    jm = jasync.make_model(jasync.AsyncIsrConfig(2, 2, 2))
    tm = tasync.make_model(tasync.AsyncIsrConfig(2, 2, 2))
    kw = dict(visited_backend=backend, **KW)
    ref = jbfs.check(jm, checkpoint_dir=str(tmp_path / "ref"), **kw)
    ref_chain = _newest(str(tmp_path / "ref"))["digest_chain"]
    jdir, tdir = str(tmp_path / "jax-first"), str(tmp_path / "port-first")
    jbfs.check(jm, checkpoint_dir=jdir, max_depth=5, **kw)
    check(tm, device="cpu", checkpoint_dir=tdir, max_depth=5, **kw)
    assert str(_newest(tdir)["ident"]) == str(_newest(jdir)["ident"])
    t_res = check(tm, device="cpu", checkpoint_dir=jdir, **kw)
    j_res = jbfs.check(jm, checkpoint_dir=tdir, **kw)
    for res, d in ((t_res, jdir), (j_res, tdir)):
        assert (res.levels, res.total, res.ok) == (ref.levels, 84, True)
        np.testing.assert_array_equal(_newest(d)["digest_chain"], ref_chain)


@pytest.mark.parametrize("backend", BACKENDS)
def test_resume_across_packages(backend, tmp_path):
    """JAX writes up to depth 5 and the port resumes; the port writes and
    JAX resumes; both end at the uninterrupted run's levels and chain."""
    jm, tm = kip320_pair()
    kw = dict(visited_backend=backend, **KW)
    ref = jbfs.check(jm, checkpoint_dir=str(tmp_path / "ref"), **kw)
    ref_chain = _newest(str(tmp_path / "ref"))["digest_chain"]
    assert ref.total == 277

    jdir, tdir = str(tmp_path / "jax-first"), str(tmp_path / "port-first")
    jbfs.check(jm, checkpoint_dir=jdir, max_depth=5, **kw)
    t_cut = check(tm, device="cpu", checkpoint_dir=tdir, max_depth=5, **kw)
    assert t_cut.levels == ref.levels[:6]
    jfile, tfile = _newest(jdir), _newest(tdir)
    assert str(tfile["ident"]) == str(jfile["ident"]) == checkpoint_ident(tm, backend, True, False)
    assert sorted(tfile) == sorted(jfile)
    for key in tfile:
        assert tfile[key].dtype == jfile[key].dtype, key
        if key not in ("host_fps", "hash_hi", "hash_lo"):  # the sets, in slot order
            np.testing.assert_array_equal(tfile[key], jfile[key], err_msg=key)
    assert tfile["frontier"].dtype == np.uint32 and tfile["frontier"].shape == (ref.levels[5], tm.spec.num_lanes)

    t_res = check(tm, device="cpu", checkpoint_dir=jdir, **kw)
    j_res = jbfs.check(jm, checkpoint_dir=tdir, **kw)
    for res, d in ((t_res, jdir), (j_res, tdir)):
        assert (res.levels, res.total, res.ok) == (ref.levels, ref.total, True)
        np.testing.assert_array_equal(_newest(d)["digest_chain"], ref_chain)
    assert t_res.stats["visited_capacity"] == ref.stats["visited_capacity"]
    # a finished run's directory resumes to the same result at once
    again = check(tm, device="cpu", checkpoint_dir=jdir, **kw)
    assert again.levels == ref.levels


def test_resume_rejects_another_backend(tmp_path):
    _, tm = kip320_pair()
    check(tm, device="cpu", checkpoint_dir=str(tmp_path), max_depth=2, **KW)
    with pytest.raises(ValueError, match="different model/config"):
        check(tm, device="cpu", checkpoint_dir=str(tmp_path), visited_backend="host", **KW)


@pytest.mark.parametrize("backend", BACKENDS)
def test_corrupt_frontier_caught_by_the_chain_on_resume(backend, tmp_path):
    """A frontier changed after the write, with fresh checksums (so the
    file verifies): the resume's level check raises, in both packages."""
    jm, tm = kip320_pair()
    check(tm, device="cpu", checkpoint_dir=str(tmp_path), max_depth=4,
          visited_backend=backend, **KW)
    path = os.path.join(str(tmp_path), CHECKPOINT_BASENAME)
    arrays = tckpt.verify_file(path)
    arrays["frontier"] = arrays["frontier"].copy()
    arrays["frontier"][0, 0] ^= 1
    np.savez(path, **{tckpt.MANIFEST_KEY: json.dumps(tckpt.build_manifest(arrays))}, **arrays)
    with pytest.raises(tinteg.IntegrityError, match="frontier"):
        check(tm, device="cpu", checkpoint_dir=str(tmp_path), visited_backend=backend, **KW)
    with pytest.raises(jinteg.IntegrityError, match="frontier"):
        jbfs.check(jm, checkpoint_dir=str(tmp_path), visited_backend=backend, **KW)


@pytest.mark.parametrize("backend", BACKENDS)
def test_violation_after_a_resume_has_no_trace(backend, tmp_path):
    """IdSequence(5) with BelowBound: cut at depth 2, resumed, violated at
    depth 4 with an empty trace, as in the JAX package (which forces
    store_trace off when checkpointing, so a fresh checkpointed run has
    none either)."""
    bound = lambda s: s["nextId"] <= 3  # noqa: E731
    jm = dataclasses.replace(jids.make_model(5), invariants=[JInvariant("BelowBound", bound)])
    tm = dataclasses.replace(tids.make_model(5), invariants=[TInvariant("BelowBound", bound)])
    kw = dict(visited_backend=backend, **KW)
    results = []
    for d, run in (("jax", lambda **a: jbfs.check(jm, **a)),
                   ("port", lambda **a: check(tm, device="cpu", **a))):
        run(checkpoint_dir=str(tmp_path / d), max_depth=2, **kw)
        results.append(run(checkpoint_dir=str(tmp_path / d), **kw))
        results.append(run(checkpoint_dir=str(tmp_path / f"{d}-fresh"), **kw))
    # the port resumes the JAX package's directory as well
    check(tm, device="cpu", checkpoint_dir=str(tmp_path / "jax-x"), max_depth=2, **kw)
    results.append(jbfs.check(jm, checkpoint_dir=str(tmp_path / "jax-x"), **kw))
    for res in results:
        v = res.violation
        assert (v.invariant, v.depth, v.state, v.trace) == ("BelowBound", 4, 4, [])
        assert res.levels == [1] * 5
