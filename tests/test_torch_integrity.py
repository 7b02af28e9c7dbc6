"""PyTorch port: the level digest chain (resilience/integrity.py) against the
JAX package's, with zero tolerance: the numpy fingerprint twin against the
port's own fingerprints, the digests, links and chain objects on random
64-bit values (the top bit and the all-ones sentinel's neighbours
included), the checkpoint validators, and the chain a check() stamps into
its checkpoints, generation by generation, over visited backend x
pipeline x compact_shift on IdSequence, FRL(2,2,2) and Kip320 2r L2 R1 E1
(with the per-level stats lines of the same runs)."""

import json

import numpy as np
import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu_torch import check, interop
from kafka_specification_tpu_torch.engine.bfs import fps_u64
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.ops.fingerprint import fingerprint_lanes
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

# 64-bit values where signed and unsigned arithmetic part ways
EDGES = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1,
                  2**64 - 3, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement")
KW = dict(min_bucket=32, chunk_size=256, compact_gate=32)
MODELS = {
    "IdSequence": lambda: (jids.make_model(6), tids.make_model(6)),
    "FRL": lambda: (jfrl.make_model(2, 2, 2), tfrl.make_model(2, 2, 2)),
    # Kip320 2r L2 R1 E1 (277 states, diameter 12): the 5,973-state E2 space
    # would cost the JAX side minutes of compiles over this matrix
    "Kip320": lambda: (jkip320.make_model(jkr.Config(2, 2, 1, 1)),
                       tkip320.make_model(tkr.Config(2, 2, 1, 1))),
}
_MODELS: dict = {}


def models(name):
    if name not in _MODELS:
        _MODELS[name] = MODELS[name]()
    return _MODELS[name]


def u64_samples(seed, n):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 2**64, size=n, dtype=np.uint64), EDGES,
                           rng.choice(EDGES, size=n // 4)])


@pytest.mark.parametrize("exact", [False, True])
def test_fingerprint_rows_equal_the_ports_fingerprints(exact):
    rng = np.random.default_rng(1)
    for k in (1, 2, 3, 7):
        rows = rng.integers(0, 2**32, size=(2000, k), dtype=np.uint32)
        rows[:4] = [[0xFFFFFFFF] * k, [0] * k, [0x80000000] * k, [0x7FFFFFFF] * k]
        port = tinteg.fingerprint_rows(rows, exact)
        assert port.dtype == np.uint64
        np.testing.assert_array_equal(port, jinteg.fingerprint_rows(rows, exact))
        hi, lo = fingerprint_lanes(interop.from_u32(rows, "cpu"), exact)
        np.testing.assert_array_equal(port, fps_u64(hi, lo))


def test_fps_u64_keeps_the_bit_pattern():
    hi = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    lo = np.array([0, 0xFFFFFFFF, 0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    got = fps_u64(interop.from_u32(hi, "cpu"), interop.from_u32(lo, "cpu"))
    np.testing.assert_array_equal(got, jinteg.pair_u64(hi, lo))
    np.testing.assert_array_equal(tinteg.pair_u64(hi, lo), jinteg.pair_u64(hi, lo))


def test_digest_and_link_equal_jax():
    for seed in range(5):
        fps = u64_samples(seed, 1000)
        assert tinteg.digest_fps(fps) == jinteg.digest_fps(fps)
        # a wrapping sum: the plain int sum mod 2^64
        assert tinteg.digest_fps(fps)[2] == sum(int(v) for v in fps) % 2**64
    assert tinteg.digest_fps(np.empty(0, np.uint64)) == (0, 0, 0)
    assert tinteg.digest_fps(EDGES[-1:]) == (1, 2**64 - 1, 2**64 - 1)
    rng = np.random.default_rng(9)
    for prev, count, xor, total in rng.integers(0, 2**64, size=(200, 4), dtype=np.uint64).tolist():
        assert tinteg.chain_link(prev, count, xor, total) == jinteg.chain_link(prev, count, xor, total)
    for v in EDGES.tolist():
        assert tinteg._splitmix64(v) == jinteg._splitmix64(v)


def _fold_levels(cls, levels):
    chain = cls()
    for d, parts in enumerate(levels):
        for part in parts:
            chain.fold(part)
        chain.seal(d, sum(len(p) for p in parts))
    return chain


def test_level_chain_equals_jax():
    rng = np.random.default_rng(4)
    levels = []
    for d in range(6):
        fps = u64_samples(d, int(rng.integers(1, 300)))
        cuts = np.sort(rng.integers(0, len(fps), size=3))
        levels.append(np.split(fps, cuts))
    port = _fold_levels(tinteg.LevelDigestChain, levels)
    jax_ = _fold_levels(jinteg.LevelDigestChain, levels)
    arr = port.to_array()
    assert arr.dtype == np.uint64 and arr.shape == (6, 4)
    np.testing.assert_array_equal(arr, jax_.to_array())
    assert port.cumulative() == jax_.cumulative()
    np.testing.assert_array_equal(tinteg.LevelDigestChain.from_array(arr).to_array(), arr)
    counts = arr[:, 0].tolist()
    np.testing.assert_array_equal(tinteg.LevelDigestChain.from_levels(counts).to_array(),
                                  jinteg.LevelDigestChain.from_levels(counts).to_array())

    # fold_digest of a digest is fold of its values; reset_fold drops a fold
    a, b = tinteg.LevelDigestChain(), tinteg.LevelDigestChain()
    a.fold(levels[0][0])
    b.fold(EDGES)
    b.reset_fold()
    b.fold_digest(*tinteg.digest_fps(levels[0][0]))
    a.seal(0, len(levels[0][0]))
    b.seal(0, len(levels[0][0]))
    assert a.entries == b.entries

    # the checks: a level's multiset, the visited set, the count at a seal
    port.verify_level(2, np.concatenate(levels[2])[::-1])
    with pytest.raises(tinteg.IntegrityError, match="frontier"):
        port.verify_level(2, np.concatenate(levels[2])[1:])
    port.verify_visited(np.concatenate([np.concatenate(p) for p in levels]))
    with pytest.raises(tinteg.IntegrityError, match="fpset"):
        port.verify_visited(np.concatenate(levels[0]))
    c = tinteg.LevelDigestChain()
    c.fold(EDGES)
    with pytest.raises(tinteg.IntegrityError, match="chain"):
        c.seal(0, len(EDGES) + 1)


def test_chain_validators_equal_jax():
    levels = [[u64_samples(d, 50)] for d in range(4)]
    chain = _fold_levels(tinteg.LevelDigestChain, levels).to_array()
    visited = np.concatenate([p[0] for p in levels])
    good = {"digest_chain": chain, "levels": chain[:, 0].astype(np.int64),
            "total": np.int64(chain[:, 0].sum()), "host_fps": visited}
    broken_link = dict(good, digest_chain=chain.copy())
    broken_link["digest_chain"][1, 3] ^= np.uint64(1)
    cases = [
        good,
        broken_link,
        dict(good, levels=good["levels"] + 1),
        dict(good, total=good["total"] + 1),
        dict(good, host_fps=visited[1:]),
        {k: v for k, v in good.items() if k != "host_fps"},
        {"levels": good["levels"]},  # a file from before the chain
    ]
    for arrays in cases:
        assert tinteg.checkpoint_chain_errors(arrays) == jinteg.checkpoint_chain_errors(arrays)
    assert tinteg.checkpoint_chain_errors(good) == []
    assert all(tinteg.checkpoint_chain_errors(a) for a in cases[1:5])
    sorted_keys = {"vhi": (visited >> np.uint64(32)).astype(np.uint32),
                   "vlo": visited.astype(np.uint32), "vn": len(visited)}
    hash_keys = {"hash_hi": sorted_keys["vhi"], "hash_lo": sorted_keys["vlo"]}
    for extra in (sorted_keys, hash_keys):
        arrays = dict({k: v for k, v in good.items() if k != "host_fps"}, **extra)
        assert tinteg.checkpoint_chain_errors(arrays) == jinteg.checkpoint_chain_errors(arrays) == []
    assert tinteg.EXIT_INTEGRITY == jinteg.EXIT_INTEGRITY


def test_integrity_switch(monkeypatch):
    monkeypatch.setenv("KSPEC_INTEGRITY", "0")
    assert not tinteg.enabled()
    res = check(models("FRL")[1], device="cpu", **KW)
    assert res.total == 49
    monkeypatch.delenv("KSPEC_INTEGRITY")
    assert tinteg.enabled()


def _generations(directory):
    """{gen: arrays} of every checkpoint generation in `directory`."""
    store = jckpt.CheckpointStore(directory, "bfs_checkpoint.npz", ident="", keep=64)
    return {g: jckpt.verify_file(store.path(g)) for g in store.generations()}


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("pipeline", ["legacy", "fused"])
@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
@pytest.mark.parametrize("name", list(MODELS))
def test_chain_in_every_checkpoint_equals_jax(name, backend, pipeline, shift, tmp_path):
    """A checkpoint every level, all kept: each generation's digest_chain
    and levels equal the JAX run's, as do the stats lines and the result.
    The chain does not depend on the knobs."""
    jm, tm = models(name)
    kw = dict(visited_backend=backend, pipeline=pipeline, compact_shift=shift,
              checkpoint_keep=64, **KW)
    jr = jbfs.check(jm, checkpoint_dir=str(tmp_path / "jax"),
                    stats_path=str(tmp_path / "jax.jsonl"), **kw)
    tr = check(tm, device="cpu", checkpoint_dir=str(tmp_path / "port"),
               stats_path=str(tmp_path / "port.jsonl"), **kw)
    assert (tr.levels, tr.total, tr.ok) == (jr.levels, jr.total, jr.ok)
    jgens, tgens = _generations(str(tmp_path / "jax")), _generations(str(tmp_path / "port"))
    assert sorted(tgens) == sorted(jgens) and len(tgens) == tr.diameter + 1
    for g in jgens:
        for key in ("digest_chain", "levels", "total", "depth"):
            np.testing.assert_array_equal(tgens[g][key], jgens[g][key], err_msg=f"gen {g} {key}")
    chain = tgens[0]["digest_chain"]
    assert chain.shape == (len(tr.levels), 4) and chain[:, 0].tolist() == tr.levels
    ref = _CHAINS.setdefault(name, chain)
    np.testing.assert_array_equal(chain, ref)

    def lines(path):
        return [{k: json.loads(line)[k] for k in DETERMINISTIC} for line in open(path)]

    assert lines(tmp_path / "port.jsonl") == lines(tmp_path / "jax.jsonl")


_CHAINS: dict = {}


def test_fingerprints_of_the_card_path_feed_the_chain():
    """fps_u64 of int64 tensors holding u32 values, with the top bit set."""
    hi = torch.tensor([0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    lo = torch.tensor([0xFFFFFFFE, 1], dtype=torch.int64)
    assert fps_u64(hi, lo).tolist() == [2**64 - 2, 2**63 + 1]
    arrays = {"vhi": interop.to_u32(hi), "vlo": interop.to_u32(lo), "vn": 2}
    np.testing.assert_array_equal(tinteg.visited_fps(arrays), fps_u64(hi, lo))
    assert tckpt.MANIFEST_KEY == jckpt.MANIFEST_KEY
