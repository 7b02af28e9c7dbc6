"""PyTorch port: the device-resident sharded level (parallel/sharded.py::
ShardedDeviceLevel, `check_sharded(pipeline="device")`) against the JAX
package's, with zero tolerance: the levels, the total, the per-shard
counts, every per-level stats record's deterministic fields,
`stats["device"]`, the per-level launches (`shard_launches`, the
`kspec_shard_launches_level` gauge) on every level the device level
served, the first violation and every value of its trace, and the level
digest chain.

The cases of JAX's tests/test_sharded_device.py, at its knobs (KW; JAX's
compiled programs are shared through the compilation cache).  The JAX side
runs five distinct device-level checks, each once per module: the
violating model on `device` and on `host` (compressed), FRL(3,3,2) at
chunk 128 (compressed: a level whose bucket outgrows the compact rows
re-dispatches raw), the violating model cut at depth 6 with a checkpoint,
and a flip@exchange.  JAX's results do not depend on the exchange (bit
identity), so the raw and all_gather runs of the port are held against the
same references but for the launches and wire bytes; the remaining cases
are held against the port's per-chunk path at the same knobs, which
tests/test_torch_sharded*.py hold against JAX with zero tolerance."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kafka_specification_tpu import pipeline_registry as jregistry
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import faults as jfaults
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.obs import metrics as tmetrics
from kafka_specification_tpu_torch.obs import tracer as ttracer
from kafka_specification_tpu_torch.ops import devlevel
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.parallel import sharded as tsharded
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.sharded_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THW = "KafkaTruncateToHighWatermark"
WEAK = ("TypeOk", "WeakIsr")
# JAX's knobs: small gated chunks, so the device level covers the chunks
# the per-chunk path runs
KW = dict(min_bucket=8, compact_gate=8, chunk_size=64)
FRL_KW = dict(min_bucket=64, compact_gate=32, chunk_size=128, store_trace=False)
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement", "shard_new", "shard_frontier", "shard_enabled")
EXCHANGES = (("all_to_all", "1"), ("all_to_all", "0"), ("all_gather", "0"))


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def jthw():
    return jvariants.make_model(THW, JConfig(2, 2, 1, 1), WEAK)


def tthw():
    return tvariants.make_model(THW, Config(2, 2, 1, 1), WEAK)


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def trace_values(res):
    if res.violation is None:
        return None
    return [(name, repr(st)) for name, st in res.violation.trace]


def records(path, extra=()):
    with open(path) as fh:
        return [{k: r[k] for k in DETERMINISTIC + tuple(extra)} for r in map(json.loads, fh)]


def launches(res):
    return [lvl["shard_launches"] for lvl in res.stats.get("levels", [])]


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


def jax_run(key, fn, tmp_path_factory, monkeypatch, extra=(), compress="1"):
    """The JAX package's run `fn(stats_path)` with its codec forced on or
    off (once per key and module): (result, stats records, chain)."""
    if key not in _JAX:
        monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", compress)
        spy = ChainSpy(monkeypatch)
        path = str(tmp_path_factory.mktemp("jax") / "stats.jsonl")
        res = fn(path)
        _JAX[key] = (res, records(path, extra), spy.array())
        monkeypatch.delenv("KSPEC_EXCHANGE_COMPRESS")
    return _JAX[key]


def jax_thw(backend, tmp_path_factory, monkeypatch):
    extra = ("shard_duplicates",) if backend == "host" else ()
    return jax_run(("thw", backend), lambda p: jsharded.check_sharded(
        jthw(), mesh=jax_mesh(4), pipeline="device", visited_backend=backend, stats_path=p,
        **KW), tmp_path_factory, monkeypatch, extra)


def port_run(monkeypatch, tmp_path, model, compress="1", **kw):
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", compress)
    spy = ChainSpy(monkeypatch)
    path = str(tmp_path / f"stats-{len(os.listdir(tmp_path))}.jsonl")
    res = check_sharded(model, stats_path=path, **kw)
    return res, path, spy.array()


@pytest.mark.parametrize("backend", ["device", "host"])
def test_violating_model_every_exchange_equals_jax(backend, monkeypatch, tmp_path,
                                                  tmp_path_factory):
    """JAX's violating case at D = 4 on `device` and `host`: the compressed
    all_to_all (JAX's compressed run, launches and wire bytes included),
    the raw all_to_all and the all_gather, each to JAX's verdict, trace
    values, records, stats["device"] and chain."""
    extra = ("shard_duplicates",) if backend == "host" else ()
    jres, jstats, jchain = jax_thw(backend, tmp_path_factory, monkeypatch)
    assert jres.stats["device"]["levels"] > 0 and jres.stats["exchange_compressed"]
    for exchange, compress in EXCHANGES:
        res, path, chain = port_run(monkeypatch, tmp_path, tthw(), compress,
                                    mesh=ShardMesh(4, "cpu"), pipeline="device",
                                    visited_backend=backend, exchange=exchange, **KW)
        assert verdict(res) == verdict(jres) and trace_values(res) == trace_values(jres)
        assert res.violation.state == jres.violation.state
        assert res.violation.depth == 8 and res.violation.invariant == "WeakIsr"
        assert records(path, extra) == jstats and np.array_equal(chain, jchain)
        assert res.stats["device"] == jres.stats["device"]
        assert res.stats["pipeline"] == "device"
        if compress == "1":
            assert launches(res) == launches(jres)
            for k in ("exchange_compressed", "exchange_bytes_total", "exchange_raw_bytes_total"):
                assert res.stats[k] == jres.stats[k], k
        if backend == "host":
            assert res.stats["host_fpset_sizes"] == jres.stats["host_fpset_sizes"]
            assert all(lvl.get("host_probe_ms") is not None for lvl in res.stats["levels"])


def test_frl_launches_per_level_equal_jax(monkeypatch, tmp_path, tmp_path_factory):
    """FRL(3,3,2) at chunk 128, D = 4, compressed: the launches of every
    level, the wire bytes and the records are JAX's; levels whose bucket
    outgrows the codec's compact rows (W // 2) re-dispatch raw at W = T,
    which costs their second launch; every level takes at most 2."""
    jres, jstats, jchain = jax_run("frl332", lambda p: jsharded.check_sharded(
        jfrl.make_model(3, 3, 2), mesh=jax_mesh(4), pipeline="device", stats_path=p,
        **FRL_KW), tmp_path_factory, monkeypatch)
    res, path, chain = port_run(monkeypatch, tmp_path, tfrl.make_model(3, 3, 2),
                                mesh=ShardMesh(4, "cpu"), pipeline="device", **FRL_KW)
    assert verdict(res) == verdict(jres) and res.total == 3375
    assert records(path) == jstats and np.array_equal(chain, jchain)
    assert res.stats["device"] == jres.stats["device"] and res.stats["device"]["levels"] == 10
    assert launches(res) == launches(jres) and max(launches(res)) == 2
    for k in ("exchange_compressed", "exchange_bytes_total", "exchange_raw_bytes_total"):
        assert res.stats[k] == jres.stats[k], k
    # the codec's overflow: the raw wire takes the level in one launch
    raw, _, _ = port_run(monkeypatch, tmp_path, tfrl.make_model(3, 3, 2), "0",
                         mesh=ShardMesh(4, "cpu"), pipeline="device", **FRL_KW)
    assert verdict(raw) == verdict(jres)
    assert [a - b for a, b in zip(launches(res), launches(raw))].count(1) >= 1


def test_one_launch_covers_a_multi_chunk_level(monkeypatch, tmp_path):
    """Chunks of 32 rows: levels the per-chunk path dispatches in two
    chunks take one launch on the device level (an exchange-level span of
    2 chunks), the gauge reads the last level's launches, and the result
    is the per-chunk path's."""
    kw = dict(KW, chunk_size=32, mesh=ShardMesh(4, "cpu"))
    ref, rpath, rchain = port_run(monkeypatch, tmp_path, tthw(), pipeline="legacy", **kw)
    spans, gauges = [], []
    monkeypatch.setattr(tsharded.RunObserver, "chunk_span",
                        lambda self, kind, s, **a: spans.append(dict(a, span=kind)))
    monkeypatch.setattr(tmetrics, "set_gauge", lambda name, v, **k: gauges.append((name, v)))
    res, path, chain = port_run(monkeypatch, tmp_path, tthw(), pipeline="device", **kw)
    assert verdict(res) == verdict(ref) and trace_values(res) == trace_values(ref)
    assert records(path) == records(rpath) and np.array_equal(chain, rchain)
    multi = [i for i, n in enumerate(launches(ref)) if n > 1]
    assert multi and all(launches(res)[i] == 1 for i in multi)
    lv = [s for s in spans if s["span"] == "exchange-level"]
    assert any(s["chunks"] > 1 and s["launches"] == 1 for s in lv)
    assert [v for name, v in gauges if name == "kspec_shard_launches_level"] == launches(res)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_level_new_overflow_redispatches_once(backend, monkeypatch, tmp_path,
                                             tmp_path_factory):
    """A level-new set of 8 entries: every larger level overflows it and
    re-dispatches once at the safe bound (2 launches), with JAX's
    result."""
    extra = ("shard_duplicates",) if backend == "host" else ()
    jres, jstats, jchain = jax_thw(backend, tmp_path_factory, monkeypatch)
    monkeypatch.setattr(devlevel, "level_new_capacity", lambda T, hw, worst: 8)
    res, path, chain = port_run(monkeypatch, tmp_path, tthw(), mesh=ShardMesh(4, "cpu"),
                                pipeline="device", visited_backend=backend, **KW)
    assert verdict(res) == verdict(jres) and trace_values(res) == trace_values(jres)
    assert records(path, extra) == jstats and np.array_equal(chain, jchain)
    assert 2 in launches(res) and max(launches(res)) == 2


class _Reads:
    """Host reads taken while a level is queued and read: fetch_global,
    Tensor.cpu, Tensor.item and Tensor.tolist calls."""

    def __init__(self, monkeypatch):
        self.on = self.inner = False
        self.queue, self.read = [], []
        self.count = 0
        real_fetch = tsharded.fetch_global

        def fetch(x):
            # one read, however fetch_global takes it
            self.tick()
            self.inner = True
            try:
                return real_fetch(x)
            finally:
                self.inner = False

        monkeypatch.setattr(tsharded, "fetch_global", fetch)
        for name in ("cpu", "item", "tolist"):
            real = getattr(torch.Tensor, name)

            def wrapped(t, *a, real=real, **k):
                self.tick()
                return real(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, wrapped)
        cls = tsharded.ShardedDeviceLevel
        real_q, real_r = cls.queue_level, cls.read_level

        def queue_level(sdev, *a, **k):
            self.on, self.count = True, 0
            try:
                return real_q(sdev, *a, **k)
            finally:
                self.queue.append(self.count)

        def read_level(sdev, *a, **k):
            self.count = 0
            try:
                return real_r(sdev, *a, **k)
            finally:
                self.read.append(self.count)
                self.on = False

        monkeypatch.setattr(cls, "queue_level", queue_level)
        monkeypatch.setattr(cls, "read_level", read_level)

    def tick(self):
        if self.on and not self.inner:
            self.count += 1


@pytest.mark.parametrize("backend", ["device", "host"])
def test_one_host_read_a_level(backend, monkeypatch, tmp_path):
    """No host read while a level's chunks are queued, one read of the
    queued level; two dispatches (two reads) only on an overflowing level:
    the launches of a level count its reads."""
    reads = _Reads(monkeypatch)
    res, _, _ = port_run(monkeypatch, tmp_path, tfrl.make_model(3, 3, 2),
                         mesh=ShardMesh(4, "cpu"), pipeline="device", visited_backend=backend,
                         **FRL_KW)
    assert res.total == 3375
    assert reads.queue and not any(reads.queue)
    assert reads.read == [1] * len(reads.read)
    assert len(reads.read) == sum(launches(res)) == res.stats["device"]["levels"] + \
        launches(res).count(2)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_deadlock_verdict_equals_per_chunk(backend, monkeypatch, tmp_path):
    """check_deadlock on the device level: IdSequence(3) deadlocks at depth
    4, elected as the per-chunk path elects it (invariants first, then the
    lowest shard, then its first row), trace for trace."""
    from kafka_specification_tpu_torch.models import id_sequence as tids

    kw = dict(mesh=ShardMesh(2, "cpu"), min_bucket=8, compact_gate=8, check_deadlock=True,
              visited_backend=backend)
    ref, rpath, rchain = port_run(monkeypatch, tmp_path, tids.make_model(3), pipeline="legacy",
                                  **kw)
    res, path, chain = port_run(monkeypatch, tmp_path, tids.make_model(3), pipeline="device",
                                **kw)
    assert (res.violation.invariant, res.violation.depth) == ("Deadlock", 4)
    assert verdict(res) == verdict(ref) and trace_values(res) == trace_values(ref)
    assert records(path) == records(rpath) and np.array_equal(chain, rchain)
    assert res.stats["device"]["levels"] == 5


def test_device_hash_degrades_with_jax_reason(monkeypatch, tmp_path):
    """device-hash has no read-only in-loop form: the run degrades before
    any level with JAX's reason, letter for letter, to the per-chunk
    result."""
    kw = dict(mesh=ShardMesh(8, "cpu"), min_bucket=64, visited_backend="device-hash")
    ref, rpath, rchain = port_run(monkeypatch, tmp_path, tfrl.make_model(3, 4, 1),
                                  pipeline="legacy", **kw)
    res, path, chain = port_run(monkeypatch, tmp_path, tfrl.make_model(3, 4, 1),
                                pipeline="device", **kw)
    assert res.total == ref.total == 125 and verdict(res) == verdict(ref)
    assert records(path) == records(rpath) and np.array_equal(chain, rchain)
    assert res.stats["device"] == {
        "levels": 0, "fallback": jregistry.backend_fallback_reason("device", "device-hash")}
    assert "device-hash" in res.stats["device"]["fallback"]


def test_compile_oom_degrades(monkeypatch, tmp_path):
    """compile_oom through KSPEC_FAULT fails the first device level: the
    run falls back stickily to the per-chunk path (JAX's pipeline-fallback
    event and reason) with the per-chunk result."""
    kw = dict(mesh=ShardMesh(4, "cpu"), min_bucket=8, compact_gate=8)
    ref, rpath, rchain = port_run(monkeypatch, tmp_path, tfrl.make_model(2, 2, 2),
                                  pipeline="legacy", **kw)
    events = []
    monkeypatch.setattr(ttracer, "event", lambda kind, **f: events.append(dict(f, kind=kind)))
    monkeypatch.setenv("KSPEC_FAULT", "compile_oom")
    res, path, chain = port_run(monkeypatch, tmp_path, tfrl.make_model(2, 2, 2),
                                pipeline="device", **kw)
    reason = f"RuntimeError: {jfaults.OOM_MARKER}"
    assert verdict(res) == verdict(ref) and records(path) == records(rpath)
    assert np.array_equal(chain, rchain)
    assert res.stats["device"] == {"levels": 0, "fallback": reason}
    assert [e for e in events if e["kind"] == "pipeline-fallback"] == [
        {"kind": "pipeline-fallback", "depth": 0, "pipeline": "sharded-device",
         "to": "per-chunk", "error": reason}]


def test_disk_tier_at_a_small_budget(monkeypatch, tmp_path, tmp_path_factory):
    """The host mode on the disk tier (forced spills): one batched
    insert_level a shard a level, JAX's host result, trace and chain."""
    jres, jstats, jchain = jax_thw("host", tmp_path_factory, monkeypatch)
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    res, path, chain = port_run(monkeypatch, tmp_path, tthw(), mesh=ShardMesh(4, "cpu"),
                                pipeline="device", store="disk", mem_budget=300,
                                spill_dir=str(tmp_path / "spill"), **KW)
    assert verdict(res) == verdict(jres) and trace_values(res) == trace_values(jres)
    assert records(path, ("shard_duplicates",)) == jstats and np.array_equal(chain, jchain)
    assert res.stats["visited_backend"] == "host" and res.stats["device"]["levels"] > 0
    assert sum(s["spills"] for s in res.stats["spill"]) > 0
