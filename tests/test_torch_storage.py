"""PyTorch port: the disk tier's storage layer (kafka_specification_tpu_torch/
storage/) against the JAX package's, with zero tolerance: the tiered
fingerprint set's novelty against a Python set and against JAX's set on the
same batches, its once-per-level insert against per-chunk inserts, the bloom
filter and its sidecar, frontier segments and the parent log with their
checksums, the budget and store knobs, and the files both packages write for
the same inputs, name for name and byte for byte."""

import json
import os

import numpy as np
import pytest

from kafka_specification_tpu import storage as jst
from kafka_specification_tpu.storage.frontier import SegmentCorrupt as JSegmentCorrupt
from kafka_specification_tpu.storage.runs import RunCorrupt as JRunCorrupt
from kafka_specification_tpu_torch import storage as tst
from kafka_specification_tpu_torch.storage.frontier import SegmentCorrupt
from kafka_specification_tpu_torch.storage.parent_log import ParentLogCorrupt
from kafka_specification_tpu_torch.storage.runs import RunCorrupt

pytestmark = pytest.mark.spill


def tree(root) -> dict:
    """relative path -> bytes of every file under `root`."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def batches(seed, n=30, hi=500, most=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, size=rng.integers(1, most), dtype=np.uint64) for _ in range(n)]


# --- the tiered fingerprint set -------------------------------------------


def test_tiered_novelty_equals_a_python_set_and_jax(tmp_path):
    """Batches with in-batch and cross-batch duplicates: the novelty masks
    equal a plain set's and JAX's set's, across spills and merges, and the
    two sets write the same run files and manifest."""
    t = tst.TieredFpSet(str(tmp_path / "t"), mem_budget=256, runs_per_merge=2)
    j = jst.TieredFpSet(str(tmp_path / "j"), mem_budget=256, runs_per_merge=2)
    ref = set()
    for batch in batches(7):
        got = t.insert(batch)
        want = np.zeros(batch.shape[0], bool)
        for i, fp in enumerate(batch.tolist()):
            if fp not in ref:
                ref.add(fp)
                want[i] = True
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(j.insert(batch), want)
    assert len(t) == len(j) == len(ref)
    assert t.stats() == j.stats()
    assert t.stats()["spills"] > 2 and t.stats()["merges"] >= 1
    probe = np.arange(600, dtype=np.uint64)
    np.testing.assert_array_equal(t.contains(probe), np.array([int(p) in ref for p in probe]))
    assert set(t.dump().tolist()) == ref
    assert t.manifest() == j.manifest()
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    np.testing.assert_array_equal(t.hot_dump(), j.hot_dump())


def test_insert_level_equals_per_chunk_inserts_and_jax(tmp_path):
    """The once-per-level insert (the device pipeline's deferred probe):
    the same masks as per-chunk inserts on a twin set, and as JAX's
    insert_level, with spills between the hot tier's slices."""
    a = tst.TieredFpSet(str(tmp_path / "a"), mem_budget=256, runs_per_merge=2)
    b = tst.TieredFpSet(str(tmp_path / "b"), mem_budget=256, runs_per_merge=2)
    j = jst.TieredFpSet(str(tmp_path / "j"), mem_budget=256, runs_per_merge=2)
    rng = np.random.default_rng(11)
    for _ in range(20):
        level = rng.choice(np.arange(2000, dtype=np.uint64), size=int(rng.integers(5, 120)),
                           replace=False).astype(np.uint64)
        got = a.insert_level(level, slice_rows=16)
        want = np.zeros(level.shape[0], bool)
        for at in range(0, level.shape[0], 16):
            want[at: at + 16] = b.insert(level[at: at + 16])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(j.insert_level(level, slice_rows=16), want)
    assert len(a) == len(b) == len(j)
    assert a.stats()["spills"] > 0
    assert set(a.dump().tolist()) == set(b.dump().tolist())
    assert tree(tmp_path / "a") == tree(tmp_path / "j")


def test_manifest_round_trip_across_packages(tmp_path):
    """A manifest and hot dump of either package restore the other's set
    in place, to the same membership."""
    fps = np.arange(100, dtype=np.uint64) * 977
    for first, second in ((tst, jst), (jst, tst)):
        d = str(tmp_path / first.__name__.split(".")[0])
        s = first.TieredFpSet(d, mem_budget=200, runs_per_merge=3)
        s.insert(fps)
        man = json.loads(json.dumps(s.manifest()))
        s2 = second.TieredFpSet.from_manifest(d, man, s.hot_dump())
        assert len(s2) == len(s)
        assert not s2.insert(fps).any()
        assert s2.insert(np.array([10**12], np.uint64)).all()


def test_deletion_barrier_waits_for_checkpoint_generations(tmp_path):
    """Merged-away runs stay on disk until `gc_barrier` saves have passed,
    and the barrier's state round-trips through the manifest."""
    s = tst.TieredFpSet(str(tmp_path / "fps"), mem_budget=64, runs_per_merge=2, gc_barrier=2)
    for b in batches(5, n=6, hi=10**6, most=12):
        s.insert(b)
    assert s.merges >= 1 and s.deleter.pending
    old = [p for _, p in s.deleter.pending]
    assert all(os.path.exists(p) for p in old)
    man = json.loads(json.dumps(s.manifest()))
    s.on_checkpoint_saved()
    assert all(os.path.exists(p) for p in old)
    s.on_checkpoint_saved()
    assert not any(os.path.exists(p) for p in old) and not s.deleter.pending
    r = tst.TieredFpSet(str(tmp_path / "other"), mem_budget=64)
    r.deleter.restore(str(tmp_path / "fps"), man["pending_delete"])
    assert [p for _, p in r.deleter.pending] == old


def test_spill_run_corruption_is_caught_on_first_lookup(tmp_path):
    s = tst.TieredFpSet(str(tmp_path), mem_budget=64, runs_per_merge=8)
    s.insert(np.arange(10, dtype=np.uint64))
    assert s.spills == 1
    path = s.runs[0].path
    with open(path, "r+b") as fh:
        fh.seek(20)
        fh.write(b"\xee")
    with pytest.raises(RunCorrupt):
        s.insert(np.arange(3, dtype=np.uint64))
    with pytest.raises(JRunCorrupt):
        jst.SortedRun(str(tmp_path), s.runs[0].meta)


# --- bloom, frontier segments, parent log ---------------------------------


def test_bloom_no_false_negatives_and_sidecar_rebuild(tmp_path):
    fps = np.random.default_rng(3).integers(0, 2**63, 5000, dtype=np.uint64)
    bf = tst.BloomFilter.build(fps)
    assert bf.maybe(fps).all()
    jf = jst.BloomFilter.build(fps)
    np.testing.assert_array_equal(bf.bits, jf.bits)
    probe = np.random.default_rng(4).integers(0, 2**63, 5000, dtype=np.uint64)
    np.testing.assert_array_equal(bf.maybe(probe), jf.maybe(probe))
    p, q = str(tmp_path / "t.bloom"), str(tmp_path / "j.bloom")
    bf.save(p)
    jf.save(q)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert tst.BloomFilter.load(q).maybe(fps).all()
    with open(p, "r+b") as fh:
        fh.seek(64)
        fh.write(b"\xff" * 32)
    assert tst.BloomFilter.load(p) is None
    # a run whose sidecar rotted rebuilds it on open, byte for byte
    meta = tst.write_run(str(tmp_path / "r.fps"), np.sort(fps), bloom_path=str(tmp_path / "r.fps.bloom"))
    good = open(str(tmp_path / "r.fps.bloom"), "rb").read()
    with open(str(tmp_path / "r.fps.bloom"), "r+b") as fh:
        fh.seek(100)
        fh.write(b"\x00" * 16)
    run = tst.SortedRun(str(tmp_path), meta)
    assert run.contains(fps).all()
    assert open(str(tmp_path / "r.fps.bloom"), "rb").read() == good


def test_frontier_round_trip_chunk_boundaries_and_jax(tmp_path):
    rows = np.arange(50, dtype=np.uint32).reshape(25, 2)
    readers = []
    for pkg, d in ((tst, tmp_path / "t"), (jst, tmp_path / "j")):
        w = pkg.FrontierWriter(str(d), level=3, lanes=2, seg_rows=7)
        for i in range(0, 25, 4):
            w.append(rows[i: i + 4])
        readers.append(w.finalize())
    r, jr = readers
    assert r.man == jr.man and r.rows == 25 and len(r.man["segments"]) == 4
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    np.testing.assert_array_equal(r.read_all(), rows)
    got = list(r.iter_chunks(6))
    assert [s for s, _ in got] == [0, 6, 12, 18, 24]
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), rows)
    np.testing.assert_array_equal(r.row(13), rows[13])
    # each package reads the other's segments
    r2 = tst.FrontierReader(str(tmp_path / "j"), json.loads(json.dumps(jr.man)))
    np.testing.assert_array_equal(r2.slice(5, 20), rows[5:20])


def test_frontier_corruption_detected(tmp_path):
    w = tst.FrontierWriter(str(tmp_path), level=0, lanes=1, seg_rows=8)
    w.append(np.arange(16, dtype=np.uint32).reshape(16, 1))
    r = w.finalize()
    seg = os.path.join(str(tmp_path), r.man["segments"][0]["name"])
    with open(seg, "r+b") as fh:
        fh.seek(20)
        fh.write(b"\xee\xee")
    with pytest.raises(SegmentCorrupt):
        tst.FrontierReader(str(tmp_path), r.man, verify=True)
    with pytest.raises(JSegmentCorrupt):
        jst.FrontierReader(str(tmp_path), r.man, verify=True)
    # the writer's own reader verifies on first read
    with pytest.raises(SegmentCorrupt):
        r.read_all()


def test_parent_log_round_trip_crc_and_jax(tmp_path):
    for pkg, d in ((tst, tmp_path / "t"), (jst, tmp_path / "j")):
        log = pkg.ParentLog(str(d), lanes=2)
        log.write_level(0, np.zeros((1, 2), np.uint32), np.full(1, -1, np.int64), np.full(1, -1))
        log.begin_level(1)
        log.append(np.ones((3, 2), np.uint32), np.zeros(3, np.int64), np.arange(3, dtype=np.int32))
        log.end_level()
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    log = tst.ParentLog(str(tmp_path / "t"), lanes=2)
    assert log.has_levels(1) and not log.has_levels(2)
    rows, parent, act = log.view()[1]
    assert rows.shape == (3, 2) and parent.tolist() == [0, 0, 0] and act.tolist() == [0, 1, 2]
    with open(os.path.join(str(tmp_path / "t"), "level-00001.plog"), "r+b") as fh:
        fh.seek(300)
        fh.write(b"\xaa\xaa")
    with pytest.raises(ParentLogCorrupt):
        log.view()[1]


def test_parse_mem_budget_and_resolve_store():
    for text in ("512M", "4G", "1.5K", 65536, "16M", "1M"):
        assert tst.parse_mem_budget(text) == jst.parse_mem_budget(text)
    assert tst.parse_mem_budget("16M") == 16 << 20
    for bad in ("zero", "-1G", "0"):
        with pytest.raises(ValueError):
            tst.parse_mem_budget(bad)
    for store in ("auto", "ram", "disk"):
        for budget in (None, "1G"):
            assert tst.resolve_store(store, budget) == jst.resolve_store(store, budget)
    with pytest.raises(ValueError):
        tst.resolve_store("floppy", None)
    assert tst.DEFAULT_MEM_BUDGET == jst.DEFAULT_MEM_BUDGET


def test_disk_tier_store_files_equal_jax(tmp_path):
    """The composed store on a seeded three-level stream: the same files,
    name for name and byte for byte, and the same manifest and stats."""
    rng = np.random.default_rng(21)
    stores = [pkg.DiskTierStore(str(tmp_path / name), 256, lanes=3, gc_barrier=2, seg_rows=5,
                                runs_per_merge=2)
              for pkg, name in ((tst, "t"), (jst, "j"))]
    init = rng.integers(0, 2**32, size=(2, 3), dtype=np.uint64).astype(np.uint32)
    for s in stores:
        s.start_fresh(init, np.array([1, 2], np.uint64))
    for level in range(1, 4):
        n = 17 * level
        rows = rng.integers(0, 2**32, size=(n, 3), dtype=np.uint64).astype(np.uint32)
        fps = rng.integers(0, 2**40, size=n, dtype=np.uint64)
        parent = rng.integers(0, 30, size=n).astype(np.int64)
        act = rng.integers(0, 5, size=n).astype(np.int32)
        for s in stores:
            s.begin_level(level)
            mask = s.fpset.insert(fps)
            s.append(rows[mask], parent[mask], act[mask])
            s.end_level()
        stores[0].on_checkpoint_saved()
        stores[1].on_checkpoint_saved()
    t, j = stores
    assert t.manifest() == j.manifest()
    assert t.stats() == j.stats()
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
