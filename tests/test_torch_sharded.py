"""PyTorch port: the sharded engine's per-chunk path (parallel/sharded.py)
against the JAX package's check_sharded, with zero tolerance, at D = 8, 4
and 2 shards: the levels, the total, the diameter, every per-level stats
record's deterministic fields (the per-shard frontier, enabled and new
counts included), the first violation and every state of its trace, and
the level digest chain, which is also the port's single-device chain.

The JAX side runs on `Mesh(jax.devices()[:D])` (tests/conftest.py gives 8
virtual CPU devices), once per case and module, at the knobs of JAX's own
tests/test_sharded.py where it has the case (so that its compiled steps
are shared through the compilation cache): its results do not depend
on the visited backend or the exchange, so one reference (the device
backend, all_gather: its fixed width compiles fewer step shapes than
all_to_all's width ladder) holds the port's whole backend x exchange matrix,
with one JAX host run for the host backend's duplicate counts.  The port
side runs a ShardMesh of D shards on the CPU.  Also: the registry's
sharded cells, the settings that items 8b's and 8c's refusals covered
(each now runs to JAX's result: the device-resident sharded level has its
own tests in tests/test_torch_sharded_device*.py), the default mesh's
device rule, the fault plan's sharded sites and the multihost helpers
without a process group."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu_torch import check, pipeline_registry
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded, multihost
from kafka_specification_tpu_torch.parallel import sharded as tsharded
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

BACKENDS = ("device", "device-hash", "host")
EXCHANGES = ("all_to_all", "all_gather")
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement", "shard_new", "shard_frontier", "shard_enabled")
WEAK = ("TypeOk", "WeakIsr")
THW = "KafkaTruncateToHighWatermark"
# name -> (D, JAX model, port model, knobs, (total, diameter) or the violation
# (invariant, depth))
CASES = {
    "FRL(3,4,1)": (8, lambda: jfrl.make_model(3, 4, 1), lambda: tfrl.make_model(3, 4, 1),
                   dict(min_bucket=64), (125, 12)),
    "FRL(2,2,2)": (4, lambda: jfrl.make_model(2, 2, 2), lambda: tfrl.make_model(2, 2, 2),
                   dict(min_bucket=32), (49, 4)),
    "Kip320 2r": (8, lambda: jkip320.make_model(jkr.Config(2, 2, 1, 1)),
                  lambda: tkip320.make_model(tkr.Config(2, 2, 1, 1)),
                  dict(min_bucket=32, chunk_size=128), (277, 11)),
    "FRL(3,3,2)": (8, lambda: jfrl.make_model(3, 3, 2), lambda: tfrl.make_model(3, 3, 2),
                   dict(min_bucket=8, chunk_size=128, store_trace=False), (3375, 9)),
    "TruncateToHW": (8, lambda: jvariants.make_model(THW, jkr.Config(2, 2, 1, 1), WEAK),
                     lambda: tvariants.make_model(THW, tkr.Config(2, 2, 1, 1), WEAK),
                     dict(min_bucket=8, chunk_size=8), ("WeakIsr", 8)),
    "deadlock": (2, lambda: jids.make_model(3), lambda: tids.make_model(3),
                 dict(min_bucket=32, check_deadlock=True), ("Deadlock", 4)),
}
_MODELS: dict = {}
_JAX: dict = {}


def models(name):
    """One model pair per case (the JAX package caches its compiled steps
    on the Model)."""
    if name not in _MODELS:
        _, jm, tm, _, _ = CASES[name]
        _MODELS[name] = (jm(), tm())
    return _MODELS[name]


def jax_mesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("d",))


class ChainSpy:
    """The chain objects that sealed a level, in the order they first did,
    for each of the two packages' LevelDigestChain classes."""

    def __init__(self, monkeypatch):
        self.made = []
        for cls in (jinteg.LevelDigestChain, tinteg.LevelDigestChain):
            real = cls.seal

            def seal(chain, depth, count, real=real):
                if not self.made or self.made[-1] is not chain:
                    self.made.append(chain)
                return real(chain, depth, count)

            monkeypatch.setattr(cls, "seal", seal)

    def last(self):
        return self.made[-1].to_array()


def stats_lines(path):
    import json

    with open(path) as fh:
        return [json.loads(line) for line in fh]


def deterministic(records, extra=()):
    return [{k: r[k] for k in DETERMINISTIC + tuple(extra)} for r in records]


def jax_reference(name, tmp_path_factory, monkeypatch, backend="device"):
    """The JAX package's run of case `name` with the all_gather exchange
    (once per module and backend): (result, stats records, chain)."""
    key = (name, backend)
    if key not in _JAX:
        D, _, _, kw, _ = CASES[name]
        spy = ChainSpy(monkeypatch)
        path = tmp_path_factory.mktemp("jax") / "stats.jsonl"
        res = jsharded.check_sharded(models(name)[0], mesh=jax_mesh(D), stats_path=str(path),
                                     visited_backend=backend, exchange="all_gather", **kw)
        _JAX[key] = (res, stats_lines(path), spy.last())
    return _JAX[key]


def port_run(name, tmp_path, monkeypatch, **extra):
    D, _, _, kw, _ = CASES[name]
    spy = ChainSpy(monkeypatch)
    path = tmp_path / "stats.jsonl"
    res = check_sharded(models(name)[1], mesh=ShardMesh(D, "cpu"), stats_path=str(path),
                        **{**kw, **extra})
    return res, stats_lines(path), spy.last()


def same_violation(a, b):
    if a is None or b is None:
        return a is b
    return (a.invariant, a.depth, a.trace, a.state) == (b.invariant, b.depth, b.trace, b.state)


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_jax(name, backend, exchange, tmp_path, tmp_path_factory, monkeypatch):
    jres, jstats, jchain = jax_reference(name, tmp_path_factory, monkeypatch)
    res, stats, chain = port_run(name, tmp_path, monkeypatch, visited_backend=backend,
                                 exchange=exchange)
    D, _, _, _, want = CASES[name]
    assert (res.levels, res.total, res.diameter) == (jres.levels, jres.total, jres.diameter)
    if isinstance(want[0], int):
        assert res.ok and (res.total, res.diameter) == want
    else:
        assert (res.violation.invariant, res.violation.depth) == want
    assert same_violation(res.violation, jres.violation)
    assert deterministic(stats) == deterministic(jstats)
    assert np.array_equal(chain, jchain)
    s = res.stats
    assert (s["devices"], s["visited_backend"], s["exchange"], s["pipeline"]) == (
        D, backend, exchange, "fused")
    assert s["mesh_layouts"] == {k: str(v.spec) for k, v in jsharded.mesh_layouts(
        jax_mesh(D)).items()}
    # the overlap layer is on by default, as in the JAX package: the host
    # backend stages its commits, and the CPU mesh sends the exchange raw
    assert s["overlap"]["enabled"] is True and not s["exchange_compressed"]
    assert 0 < s["overlap"]["staged_chunks_peak"] <= 2 if backend == "host" else \
        s["overlap"]["staged_chunks_peak"] == 0
    if backend == "host" and res.ok:
        assert sum(s["host_fpset_sizes"]) == res.total
    if backend == "device-hash" and res.ok:
        assert sum(s["shard_visited"]) == res.total


@pytest.mark.parametrize("name", list(CASES))
def test_chain_equals_the_single_device_chain(name, tmp_path, monkeypatch):
    """The chain digests the level multisets: the port's single-device
    check() of the same model seals the same entries."""
    _, _, chain = port_run(name, tmp_path, monkeypatch)
    D, _, _, kw, _ = CASES[name]
    spy = ChainSpy(monkeypatch)
    res = check(models(name)[1], device="cpu", check_deadlock=kw.get("check_deadlock", False))
    assert res.levels == [int(c) for c in chain[:, 0]]
    assert np.array_equal(spy.last(), chain)


def test_host_duplicates_equal_jax_host(tmp_path, tmp_path_factory, monkeypatch):
    """The host backend's per-shard duplicates (first copies the owner's
    set had already) against JAX's host run."""
    jres, jstats, jchain = jax_reference("FRL(2,2,2)", tmp_path_factory, monkeypatch,
                                         backend="host")
    res, stats, chain = port_run("FRL(2,2,2)", tmp_path, monkeypatch, visited_backend="host")
    assert deterministic(stats, ("shard_duplicates",)) == deterministic(
        jstats, ("shard_duplicates",))
    assert res.stats["host_fpset_sizes"] == jres.stats["host_fpset_sizes"]
    assert np.array_equal(chain, jchain)


def test_cut_frontier_invariant_pass_and_max_states_equal_jax(tmp_path, monkeypatch):
    """max_depth stops before the violating level is expanded, and the cut
    frontier's invariant pass finds JAX's violation and trace; max_states
    stops at JAX's level boundary with JAX's progress calls."""
    jm, tm = models("TruncateToHW")
    kw = dict(CASES["TruncateToHW"][3])
    jres = jsharded.check_sharded(jm, mesh=jax_mesh(8), max_depth=8, exchange="all_gather",
                                  **kw)
    res = check_sharded(tm, mesh=ShardMesh(8, "cpu"), max_depth=8, **kw)
    assert res.levels == jres.levels and (res.violation.invariant, res.violation.depth) == (
        "WeakIsr", 8)
    assert same_violation(res.violation, jres.violation)
    jm, tm = models("FRL(2,2,2)")
    calls, jcalls = [], []
    jres = jsharded.check_sharded(jm, mesh=jax_mesh(4), max_states=20, min_bucket=32,
                                  exchange="all_gather", progress=lambda *a: jcalls.append(a))
    res = check_sharded(tm, mesh=ShardMesh(4, "cpu"), max_states=20, min_bucket=32,
                        progress=lambda *a: calls.append(a))
    assert (res.levels, res.total, calls) == (jres.levels, jres.total, jcalls)
    assert res.total < 49


def test_registry_sharded_cells_and_pipeline_names(tmp_path, monkeypatch):
    """legacy runs the per-chunk step, fused names it, device runs the
    device-resident sharded level (JAX's cell, detail for detail);
    `pipeline=` lands in the stats."""
    from kafka_specification_tpu import pipeline_registry as jregistry

    cells = {n: pipeline_registry.engine_support(n, "sharded") for n in pipeline_registry.PIPELINES}
    assert cells["legacy"]["supported"] is True
    assert cells["fused"]["supported"] is False and "per-chunk" in cells["fused"]["detail"]
    assert cells["device"] == jregistry.engine_support("device", "sharded")
    assert cells["device"]["supported"] is True and "level program" in cells["device"]["detail"]
    _, tm = models("FRL(2,2,2)")
    for name in ("legacy", "fused", "device"):
        res = check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32, pipeline=name)
        assert res.total == 49 and res.stats["pipeline"] == name
    from kafka_specification_tpu_torch import cli

    assert cli.main(["pipelines"]) == 0


REFUSED = {
    "pipeline=device": (dict(pipeline="device"), {}),
    "KSPEC_PIPELINE=device": ({}, {"KSPEC_PIPELINE": "device"}),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_items_of_8b_raise_loudly(what, tmp_path, tmp_path_factory, monkeypatch):
    """The device-resident sharded level, the leg of the former item 8b that
    the port refused until ROADMAP item 8c was ported, runs FRL(2,2,2) at
    D = 4 on the device level (its chunks gated at 8 rows) to JAX's levels,
    stats records, chain and verdict."""
    jres, jstats, jchain = jax_reference("FRL(2,2,2)", tmp_path_factory, monkeypatch)
    kw, env = REFUSED[what]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    res, stats, chain = port_run("FRL(2,2,2)", tmp_path, monkeypatch, compact_gate=8, **kw)
    assert (res.levels, res.total, res.diameter, res.ok) == (jres.levels, jres.total,
                                                              jres.diameter, jres.ok)
    assert deterministic(stats) == deterministic(jstats)
    assert np.array_equal(chain, jchain)
    assert res.stats["pipeline"] == "device"
    assert res.stats["device"]["fallback"] is None and res.stats["device"]["levels"] > 0


# the settings item 8b's refusals covered, each of which now runs
FORMER_8B = {
    "KSPEC_EXCHANGE_COMPRESS=1": ({}, {"KSPEC_EXCHANGE_COMPRESS": "1"}),
    "overlap=True": (dict(overlap=True), {}),
    "overlap=on": (dict(overlap="on"), {}),
    "KSPEC_OVERLAP=on": ({}, {"KSPEC_OVERLAP": "on"}),
    "store=disk": (dict(store="disk"), {}),
    "mem_budget": (dict(mem_budget="1M"), {}),
    "disk_budget": (dict(disk_budget=1 << 30), {}),
    "KSPEC_DISK_BUDGET": ({}, {"KSPEC_DISK_BUDGET": "1G"}),
    "KSPEC_LEVEL_DEADLINE": ({}, {"KSPEC_LEVEL_DEADLINE": "600"}),
}


@pytest.mark.parametrize("what", list(FORMER_8B))
def test_former_8b_settings_run_to_jax_result(what, tmp_path, tmp_path_factory, monkeypatch):
    """Each setting the port refused under item 8b runs FRL(2,2,2) at D = 4
    to the JAX package's levels, stats records, chain and verdict."""
    jres, jstats, jchain = jax_reference("FRL(2,2,2)", tmp_path_factory, monkeypatch)
    kw, env = FORMER_8B[what]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if kw.get("store") == "disk" or "mem_budget" in kw:
        kw = dict(kw, spill_dir=str(tmp_path / "spill"))
    res, stats, chain = port_run("FRL(2,2,2)", tmp_path, monkeypatch, **kw)
    assert (res.levels, res.total, res.diameter, res.ok) == (jres.levels, jres.total,
                                                              jres.diameter, jres.ok)
    assert deterministic(stats) == deterministic(jstats)
    assert np.array_equal(chain, jchain)
    if what == "KSPEC_EXCHANGE_COMPRESS=1":
        assert res.stats["exchange_compressed"] is True
    if "spill_dir" in kw:
        assert res.stats["visited_backend"] == "host" and res.stats["spill"]


def test_serial_overlap_settings_run(monkeypatch):
    _, tm = models("FRL(2,2,2)")
    assert check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32, overlap=False).total == 49
    monkeypatch.setenv("KSPEC_OVERLAP", "off")
    assert check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32).total == 49


def test_runs_on_the_card_unless_told_the_cpu(monkeypatch):
    """No mesh, or a mesh given no device: the card; without CUDA that
    raises, it never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = models("FRL(2,2,2)")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_sharded(tm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_sharded(tm, mesh=ShardMesh(2, "cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_sharded(tm, mesh=ShardMesh(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardMesh.default()
    res = check_sharded(tm, device="cpu", min_bucket=32)
    assert res.total == 49 and res.stats["devices"] == 1


def test_fault_sites_of_the_sharded_engine(monkeypatch):
    """compile_oom is wired: it fires on the device level, the sharded
    engine's escalated attempt, and passes the per-chunk step, which never
    escalates.  The sharded engine wires every site check() wires, and
    flip@exchange, which check() refuses; a shard scope outside the mesh
    is refused."""
    from kafka_specification_tpu_torch.resilience.faults import WIRED_SHARDED

    assert ("compile_oom", None) in WIRED_SHARDED
    _, tm = models("FRL(2,2,2)")
    monkeypatch.setenv("KSPEC_FAULT", "compile_oom")
    res = check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32)
    assert res.total == 49 and "device" not in res.stats
    monkeypatch.setenv("KSPEC_FAULT", "crash@shard5:level:2")
    with pytest.raises(ValueError, match="shard 5 is out of range"):
        check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32)
    monkeypatch.setenv("KSPEC_FAULT", "flip@exchange:99")
    assert check_sharded(tm, mesh=ShardMesh(4, "cpu"), min_bucket=32).total == 49
    with pytest.raises(ValueError, match="flip@exchange"):
        check(tm, device="cpu")


def test_multihost_helpers_without_a_group():
    import torch

    assert not multihost.group_active() and multihost.process_count() == 1
    assert multihost.is_coordinator() and not multihost.is_multiprocess()
    x = torch.arange(6).reshape(2, 3)
    assert np.array_equal(multihost.fetch_global(x), x.numpy())
    m = np.array([True, False])
    assert multihost.or_across_processes(m) is m
    assert multihost.max_across_processes(7) == 7
    rows = [torch.arange(4).reshape(2, 2), torch.zeros((0, 2), dtype=torch.int64)]
    assert multihost.gather_rows(rows, 2) == rows
    mesh = ShardMesh(4, "cpu")
    assert (mesh.size, mesh.my_shards, mesh.shard_proc) == (4, [0, 1, 2, 3], [0] * 4)
    # the all_to_all exchange within one process: a transpose
    send = [torch.stack([torch.full((1, 1), 10 * s + o, dtype=torch.int32) for o in range(4)])
            for s in range(4)]
    recv = multihost.all_to_all_shards(send, mesh)
    assert [r.flatten().tolist() for r in recv] == [[10 * s + o for s in range(4)]
                                                  for o in range(4)]
    with pytest.raises(ValueError):
        ShardMesh(0, "cpu")
    assert tsharded._combine_digs(np.array([[1, 3, 5, 2**32 - 1, 7], [2, 1, 4, 2, 1]])) == (
        3, 2, 1, 1, 8)
