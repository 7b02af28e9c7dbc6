"""PyTorch port: the sharded engine's overlap legs (parallel/sharded.py)
against the JAX package's check_sharded, with zero tolerance: the
compressed all_to_all (ops/fpcompress.py), the staged host commit, the
async checkpoint writes and the disk tier's merges on the worker, each on
and off, give JAX's levels, total, diameter, per-level stats records
(their deterministic fields), first violation with every trace value and
digest chain.  The cases of JAX's tests/test_overlap.py, at its knobs (so
that its compiled steps are shared); JAX's results do not depend on the
layer (bit-identity), so each case holds the port's whole matrix against
one JAX run, and the compressed case its compressed runs against JAX's
compressed one."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.resilience.integrity import IntegrityError as JIntegrityError
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.ops import fpcompress
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.resilience.faults import InjectedCrash
from kafka_specification_tpu_torch.resilience.integrity import IntegrityError
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.overlap

THW = "KafkaTruncateToHighWatermark"
WEAK = ("TypeOk", "WeakIsr")
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement", "shard_new", "shard_frontier", "shard_enabled")
# (overlap, compress) settings of the port's matrix
LAYER = (("0", ""), ("1", "0"), ("1", "1"))


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def trace_values(res):
    if res.violation is None:
        return None
    return [(name, repr(st)) for name, st in res.violation.trace]


def records(path, extra=()):
    import json

    with open(path) as fh:
        return [{k: r[k] for k in DETERMINISTIC + tuple(extra)}
                for r in map(json.loads, fh)]


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

    def array(self):
        return self.last.to_array()


_JAX: dict = {}


def jax_run(key, fn, tmp_path_factory, monkeypatch, extra=(), env=(("KSPEC_OVERLAP", "0"),)):
    """The JAX package's run `fn(stats_path)` under `env` (by default its
    layer off; once per key and module): (result, stats records, chain)."""
    if key not in _JAX:
        for name, value in env:
            monkeypatch.setenv(name, value)
        spy = ChainSpy(monkeypatch)
        path = str(tmp_path_factory.mktemp("jax") / "stats.jsonl")
        res = fn(path)
        _JAX[key] = (res, records(path, extra), spy.array())
        for name, _value in env:
            monkeypatch.delenv(name)
    return _JAX[key]


def port_run(monkeypatch, tmp_path, overlap, compress, model, **kw):
    monkeypatch.setenv("KSPEC_OVERLAP", overlap)
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", compress)
    spy = ChainSpy(monkeypatch)
    path = str(tmp_path / f"stats-{overlap}-{compress}.jsonl")
    res = check_sharded(model, stats_path=path, **kw)
    return res, path, spy.array()


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_overlap_bit_identity_sharded_compressed(backend, monkeypatch, tmp_path,
                                                 tmp_path_factory):
    """JAX's case at D = 4: the violating model with the layer off against
    the port's off and on with the raw wire, and JAX's compressed run
    (KSPEC_EXCHANGE_COMPRESS=1) against the port's, on every backend: the
    verdict, every trace value, the stats records and the chain.  The
    compressed run's raw bytes are what the raw wire sent for the same
    chunks."""
    def jax_model(p):
        return jsharded.check_sharded(jvariants.make_model(THW, JConfig(2, 2, 1, 1), WEAK),
                                      mesh=jax_mesh(4), min_bucket=64, stats_path=p)

    ref = {False: jax_run("thw4", jax_model, tmp_path_factory, monkeypatch),
           True: jax_run("thw4-compressed", jax_model, tmp_path_factory, monkeypatch,
                         env=(("KSPEC_OVERLAP", "1"), ("KSPEC_EXCHANGE_COMPRESS", "1")))}
    assert ref[True][0].stats["exchange_compressed"]
    raw_wire = None
    for overlap, compress in LAYER:
        jres, jstats, jchain = ref[compress == "1"]
        res, path, chain = port_run(monkeypatch, tmp_path, overlap, compress,
                                    tvariants.make_model(THW, Config(2, 2, 1, 1), WEAK),
                                    mesh=ShardMesh(4, "cpu"), min_bucket=64,
                                    visited_backend=backend)
        assert verdict(res) == verdict(jres) and trace_values(res) == trace_values(jres)
        assert res.violation.state == jres.violation.state
        assert records(path) == jstats and np.array_equal(chain, jchain)
        s = res.stats
        assert s["overlap"]["enabled"] is (overlap == "1")
        assert s["exchange_compressed"] is (compress == "1")
        sent, raw = s["exchange_bytes_total"], s["exchange_raw_bytes_total"]
        if compress == "1":
            assert sent > 0 and raw == raw_wire, (sent, raw, raw_wire)
        else:
            assert sent == raw > 0
            raw_wire = sent


def test_overlap_bit_identity_sharded_host_backend(monkeypatch, tmp_path, tmp_path_factory):
    """JAX's host case (FRL(2,2,2) at D = 2): the staged commit gives JAX's
    result and JAX's staged-chunk peak, at most 2."""
    jres, jstats, jchain = jax_run(
        "frl2", lambda p: jsharded.check_sharded(
            jfrl.make_model(2, 2, 2), mesh=jax_mesh(2), min_bucket=64, visited_backend="host",
            stats_path=p), tmp_path_factory, monkeypatch, ("shard_duplicates",))
    monkeypatch.setenv("KSPEC_OVERLAP", "1")
    jon = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(2), min_bucket=64,
                                 visited_backend="host")
    res, path, chain = port_run(monkeypatch, tmp_path, "1", "", tfrl.make_model(2, 2, 2),
                                mesh=ShardMesh(2, "cpu"), min_bucket=64, visited_backend="host")
    assert verdict(res) == verdict(jres) == verdict(jon)
    assert records(path, ("shard_duplicates",)) == jstats and np.array_equal(chain, jchain)
    assert res.stats["overlap"]["staged_chunks_peak"] == jon.stats["overlap"][
        "staged_chunks_peak"] <= 2
    assert res.stats["host_fpset_sizes"] == jres.stats["host_fpset_sizes"]


def test_staged_commit_of_many_chunks_and_a_mid_level_verdict(monkeypatch, tmp_path,
                                                             tmp_path_factory):
    """Chunks of 8 rows at D = 8 (the trace model of tests/test_torch_
    sharded.py): every level stages its chunks two deep, the violating
    chunk's commit finds the verdict with the next chunk already
    dispatched, and the result is JAX's, trace and chain included, with
    the layer on and off and both wires."""
    kw = dict(min_bucket=8, chunk_size=8)
    jres, jstats, jchain = jax_run(
        "thw8", lambda p: jsharded.check_sharded(
            jvariants.make_model(THW, JConfig(2, 2, 1, 1), WEAK), mesh=jax_mesh(8),
            exchange="all_gather", stats_path=p, **kw), tmp_path_factory, monkeypatch)
    for overlap, compress in LAYER:
        res, path, chain = port_run(monkeypatch, tmp_path, overlap, compress,
                                    tvariants.make_model(THW, Config(2, 2, 1, 1), WEAK),
                                    mesh=ShardMesh(8, "cpu"), visited_backend="host", **kw)
        assert verdict(res) == verdict(jres) and trace_values(res) == trace_values(jres)
        assert records(path) == jstats and np.array_equal(chain, jchain)
        assert res.stats["overlap"]["staged_chunks_peak"] == (2 if overlap == "1" else 0)


def test_compressed_overflow_at_full_width_falls_back_to_raw(monkeypatch, tmp_path,
                                                            tmp_path_factory):
    """A starved stream budget overflows the codec at every width: once the
    width reaches a whole source's candidates the chunk goes raw, with
    JAX's result; the byte count is raw-dominated, as JAX's."""
    jres, jstats, jchain = jax_run(
        "frl3", lambda p: jsharded.check_sharded(
            jfrl.make_model(2, 2, 3), mesh=jax_mesh(2), min_bucket=64, stats_path=p),
        tmp_path_factory, monkeypatch)
    monkeypatch.setattr(fpcompress, "default_stream_words", lambda w: fpcompress.BLK)
    res, path, chain = port_run(monkeypatch, tmp_path, "1", "1", tfrl.make_model(2, 2, 3),
                                mesh=ShardMesh(2, "cpu"), min_bucket=64)
    assert verdict(res) == verdict(jres)
    assert records(path) == jstats and np.array_equal(chain, jchain)
    assert res.stats["exchange_compressed"]
    assert res.stats["exchange_bytes_total"] >= 0.5 * res.stats["exchange_raw_bytes_total"]


def test_sharded_flip_exchange_detected_through_compression(monkeypatch):
    """flip@exchange trips the framing check with the compressed wire (the
    received digest is taken over the decoded lanes): the port raises
    JAX's IntegrityError, message for message."""
    monkeypatch.setenv("KSPEC_OVERLAP", "1")
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", "1")
    monkeypatch.setenv("KSPEC_FAULT", "flip@exchange:2")
    with pytest.raises(IntegrityError) as ei:
        check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(2, "cpu"), min_bucket=64)
    assert ei.value.site == "exchange" and ei.value.depth == 1
    with pytest.raises(JIntegrityError) as ej:
        jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(2), min_bucket=64)
    assert str(ei.value) == str(ej.value)


def test_sharded_crash_merge_on_worker_resumes(monkeypatch, tmp_path, tmp_path_factory):
    """crash@merge:1 fires on the kspec-io worker of a shard's tiered set;
    the resume reaches JAX's result (the checkpoint, the runs and the
    manifests survived)."""
    jres, _, jchain = jax_run(
        "frl2", lambda p: jsharded.check_sharded(
            jfrl.make_model(2, 2, 2), mesh=jax_mesh(2), min_bucket=64, visited_backend="host",
            stats_path=p), tmp_path_factory, monkeypatch, ("shard_duplicates",))
    ck = str(tmp_path / "ck")
    kw = dict(mesh=ShardMesh(2, "cpu"), min_bucket=64, mem_budget=128, store="disk",
              checkpoint_dir=ck, spill_dir=str(tmp_path / "spill"))
    monkeypatch.setenv("KSPEC_OVERLAP", "1")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    monkeypatch.setenv("KSPEC_FAULT", "crash@merge:1")
    with pytest.raises(InjectedCrash):
        check_sharded(tfrl.make_model(2, 2, 2), **kw)
    monkeypatch.delenv("KSPEC_FAULT")
    res = check_sharded(tfrl.make_model(2, 2, 2), **kw)
    assert verdict(res) == verdict(jres)
    final = tckpt.verify_file(os.path.join(ck, "sharded_checkpoint.npz"))
    assert np.array_equal(final["digest_chain"], jchain)
    assert sum(s["merges"] for s in res.stats["spill"] if s) >= 1


def test_async_checkpoints_resume_in_the_jax_package(monkeypatch, tmp_path):
    """Checkpoints written on the kspec-ckpt thread (a generation a level,
    each promoted before the next is queued) resume in the JAX package to
    its result."""
    monkeypatch.setenv("KSPEC_OVERLAP", "1")
    ck = str(tmp_path / "ck")
    cut = check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32,
                        max_depth=3, checkpoint_dir=ck)
    assert cut.stats["overlap"]["ckpt_worker"]["jobs"] == 3
    assert sorted(n for n in os.listdir(ck) if n.endswith(".npz")) == [
        "sharded_checkpoint.1.npz", "sharded_checkpoint.2.npz", "sharded_checkpoint.npz"]
    jres = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(4), min_bucket=32,
                                  checkpoint_dir=ck)
    whole = check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32)
    assert verdict(jres) == verdict(whole) and jres.total == 49
