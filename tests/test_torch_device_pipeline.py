"""PyTorch port: the device-resident level pipeline (check(pipeline=
"device"), engine/pipeline.py::DevicePipeline) against the JAX package's
pipeline="device", with zero tolerance, on the CPU (K1's plain version):
every level's rows in order, total, diameter, the first violation and its
trace, the per-level stats lines, stats["device"], the visited capacity and
the digest chain, on the sorted `device` backend and the deferred-probe
`host` backend, for TruncateToHW 2r (WeakIsr at depth 8), Kip101 2r and
AsyncIsr 2r, with the JAX package's test knobs (min_bucket 32, chunk_size
256, compact_gate 32; tests/test_pipeline.py).  Then the edges: device-hash
degrading with the JAX package's reason, an un-gated tail chunk, a forced
width overflow and a forced level-new overflow (each re-dispatches and
still gives the JAX package's result), checkpoints and max_states under the
pipeline, the digest against digest_fps, the fixed-capacity dedup and the
width policy against their references, and `cli check --pipeline device`.
The JAX side of each case runs once (module cache): its compiles dominate."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.engine import pipeline as jpipeline
from kafka_specification_tpu.models import async_isr as jasync
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.ops import devlevel as jdevlevel
from kafka_specification_tpu.pipeline_registry import backend_fallback_reason
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.utils import cli as jcli
from kafka_specification_tpu_torch import check, cli, interop
from kafka_specification_tpu_torch.engine import bfs as tbfs
from kafka_specification_tpu_torch.engine import pipeline as tpipeline
from kafka_specification_tpu_torch.models import async_isr as tasync
from kafka_specification_tpu_torch.models import base as tbase
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.ops import dedup, devlevel
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from torch_guards import overlap_guard  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _runs_root(tmp_path, monkeypatch):
    """Each CLI check's run directory lands under this test's tmp_path."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))


REPO = Path(__file__).resolve().parents[1]
KW = dict(min_bucket=32, chunk_size=256, compact_gate=32)
TAIL_KW = dict(min_bucket=16, chunk_size=32, compact_gate=32)
THW = "KafkaTruncateToHighWatermark"
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement")


def models(name):
    if name == "AsyncIsr":
        jc = jasync.AsyncIsrConfig(2, 2, 2)
        return (jasync.make_model(jc),
                tasync.make_model(interop.async_isr_config_from_jax(jc)))
    jc, tc = jkr.Config(2, 2, 1, 1), tkr.Config(2, 2, 1, 1)
    invs = ("TypeOk", "WeakIsr")
    return jvariants.make_model(name, jc, invs), tvariants.make_model(name, tc, invs)


class _Chains:
    """Records each LevelDigestChain a check() makes (both packages)."""

    def __init__(self, monkeypatch):
        self.made = []
        rec = self.made
        for mod in (jinteg, tinteg):
            base = mod.LevelDigestChain

            class Recording(base):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    rec.append(self)

            monkeypatch.setattr(mod, "LevelDigestChain", Recording)

    def last(self):
        return [tuple(e) for e in self.made[-1].to_array().tolist()]


@pytest.fixture
def chains(monkeypatch):
    return _Chains(monkeypatch)


class _Run:
    def __init__(self, res, levels, stats, chain):
        self.res, self.levels, self.stats, self.chain = res, levels, stats, chain


def run(checker, model, chains, tmp, **kw):
    """One check with every level's rows, the stats lines and the chain."""
    levels = []
    path = tmp / f"stats-{len(chains.made)}.jsonl"
    res = checker(model, collect_levels=levels, stats_path=str(path), **kw)
    with open(path) as fh:
        stats = [{k: json.loads(line)[k] for k in DETERMINISTIC} for line in fh]
    return _Run(res, [np.asarray(interop.to_u32(x) if torch.is_tensor(x) else x) for x in levels],
                stats, chains.last())


_JAX: dict = {}


def jax_run(key, chains, tmp_path_factory, **kw):
    """The JAX package's pipeline="device" run of a case, once per module."""
    if key not in _JAX:
        jm, _ = models(key[0])
        _JAX[key] = run(jbfs.check, jm, chains, tmp_path_factory.mktemp("jax"),
                        pipeline="device", **kw)
    return _JAX[key]


def port_run(name, chains, tmp_path, **kw):
    _, tm = models(name)
    return run(check, tm, chains, tmp_path, device="cpu", pipeline="device", **kw)


def same(j, t, capacity=True):
    jr, tr = j.res, t.res
    assert tr.levels == jr.levels and (tr.total, tr.diameter) == (jr.total, jr.diameter)
    assert len(t.levels) == len(j.levels)
    for d, (a, b) in enumerate(zip(t.levels, j.levels)):
        np.testing.assert_array_equal(a, b, err_msg=f"level {d}")
    assert (tr.violation is None) == (jr.violation is None)
    if jr.violation is not None:
        tv, jv = tr.violation, jr.violation
        assert (tv.invariant, tv.depth, tv.state) == (jv.invariant, jv.depth, jv.state)
        assert tv.trace == jv.trace
    assert t.stats == j.stats
    assert t.chain == j.chain
    assert tr.stats["device"] == jr.stats["device"]
    assert tr.stats["pipeline"] == jr.stats["pipeline"] == "device"
    if capacity:
        assert tr.stats["visited_capacity"] == jr.stats["visited_capacity"]


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("name", [THW, "Kip101", "AsyncIsr"])
def test_device_pipeline_equals_jax(name, backend, chains, tmp_path, tmp_path_factory):
    j = jax_run((name, backend), chains, tmp_path_factory, visited_backend=backend, **KW)
    t = port_run(name, chains, tmp_path, visited_backend=backend, **KW)
    same(j, t)
    assert t.res.stats["device"]["levels"] > 0 and t.res.stats["device"]["fallback"] is None
    if name == THW:
        assert (t.res.violation.invariant, t.res.violation.depth) == ("WeakIsr", 8)


def test_device_hash_degrades_with_the_jax_reason(chains, tmp_path, tmp_path_factory):
    j = jax_run(("AsyncIsr", "device-hash"), chains, tmp_path_factory,
                visited_backend="device-hash", **KW)
    t = port_run("AsyncIsr", chains, tmp_path, visited_backend="device-hash", **KW)
    same(j, t)
    assert t.res.stats["device"] == {
        "levels": 0, "fallback": backend_fallback_reason("device", "device-hash")}


def test_ungated_tail_chunk(chains, tmp_path, tmp_path_factory):
    """chunk_size 32 with min_bucket 16: a level of 60 runs one gated chunk
    and a 28-row tail at bucket 32 on the card; a level of 14 (bucket 16,
    below the gate) runs per chunk."""
    j = jax_run((THW, "tail"), chains, tmp_path_factory, visited_backend="device", **TAIL_KW)
    t = port_run(THW, chains, tmp_path, visited_backend="device", **TAIL_KW)
    same(j, t)
    plan = tpipeline.DevicePipeline(models(THW)[1], "device", True, False, 2, 32).plan_level
    assert plan(60, 32, 16) == (32, 2, 60)
    assert plan(14, 32, 16) is None
    assert plan(40, 32, 16) == (32, 1, 32)  # the 8-row tail runs per chunk


class _Counting(tpipeline.DevicePipeline):
    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.reads = 0
        _Counting.made.append(self)

    def read_level(self, st):
        self.reads += 1
        return super().read_level(st)


@pytest.fixture
def counting(monkeypatch):
    _Counting.made = []
    monkeypatch.setattr(tbfs, "DevicePipeline", _Counting)
    return _Counting.made


@pytest.mark.parametrize("backend", ["device", "host"])
def test_forced_width_overflow_redispatches(backend, chains, counting, monkeypatch, tmp_path,
                                            tmp_path_factory):
    """Widths of one row an action: every level with more enabled cells
    overflows and re-dispatches at its measured maxima; the result is the
    JAX package's all the same."""
    j = jax_run((THW, backend), chains, tmp_path_factory, visited_backend=backend, **KW)
    real = tpipeline.DevicePipeline.widths

    def tiny(self, B, counts=None):
        return real(self, B, counts) if counts is not None else (1,) * len(self.model.actions)

    monkeypatch.setattr(tpipeline.DevicePipeline, "widths", tiny)
    t = port_run(THW, chains, tmp_path, visited_backend=backend, **KW)
    same(j, t, capacity=False)
    pipe = counting[-1]
    assert pipe.reads > pipe.levels  # at least one level read twice


def test_forced_level_new_overflow_redispatches(chains, counting, monkeypatch, tmp_path,
                                                tmp_path_factory):
    """A level-new set of 8 entries: a two-chunk level with more new states
    overflows it and re-dispatches at the safe bound."""
    j = jax_run((THW, "tail"), chains, tmp_path_factory, visited_backend="device", **TAIL_KW)
    monkeypatch.setattr(devlevel, "level_new_capacity", lambda T, hw, worst: 8)
    t = port_run(THW, chains, tmp_path, visited_backend="device", **TAIL_KW)
    same(j, t, capacity=False)
    pipe = counting[-1]
    assert pipe.reads > pipe.levels


def test_checkpoint_resume_and_max_states(chains, tmp_path, tmp_path_factory):
    """A run cut at depth 6 with checkpoints and resumed under the device
    pipeline ends with the JAX package's chain and levels; max_states cuts
    where JAX's cuts."""
    j = jax_run(("Kip101", "device"), chains, tmp_path_factory, visited_backend="device", **KW)
    _, tm = models("Kip101")
    ck = tmp_path / "ck"
    check(tm, device="cpu", pipeline="device", checkpoint_dir=str(ck), max_depth=6, **KW)
    res = check(tm, device="cpu", pipeline="device", checkpoint_dir=str(ck), **KW)
    assert res.levels == j.res.levels and res.stats["device"]["fallback"] is None
    assert chains.last() == j.chain
    jm, _ = models("Kip101")
    jcut = jbfs.check(jm, pipeline="device", max_states=200, **KW)
    cut = check(tm, device="cpu", pipeline="device", max_states=200, **KW)
    assert cut.levels == jcut.levels and cut.stats["device"] == jcut.stats["device"]


def test_opaque_kernel_records_the_hull_fallback():
    """A kernel outside the interval domain: no proven hulls, so the run
    takes the per-chunk path and says why."""
    _, tm = models("AsyncIsr")
    a = tm.actions[0]

    def opaque(s):
        en, nxt = a.kernel(s)
        return en & (torch.nonzero(en).shape[0] >= 0), nxt

    tm.actions = [tbase.Action(a.name, a.n_choices, opaque, writes=a.writes)] + tm.actions[1:]
    res = check(tm, device="cpu", pipeline="device", **KW)
    assert res.total == 84 and res.stats["device"]["levels"] == 0
    assert res.stats["device"]["fallback"].startswith("no proven field hulls")


def test_digest_equals_digest_fps():
    """(count, xor, sum) over random multisets, bit 63 set on many, chunked
    and combined, equal to both packages' digest_fps."""
    rng = np.random.default_rng(0)
    for n in (0, 1, 255, 256, 1000, 70000):
        fps = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        fps[: n // 3] |= np.uint64(1 << 63)
        keep = rng.random(n) < 0.7
        t = torch.from_numpy(fps.view(np.int64))
        acc = devlevel.zero_digest("cpu")
        for part in np.array_split(np.arange(n), 3):
            idx = torch.from_numpy(part)
            acc = devlevel.combine_digest(acc, devlevel.masked_digest(t[idx], torch.from_numpy(keep)[idx]))
        want = tinteg.digest_fps(fps[keep])
        assert devlevel.digest_ints(acc) == want == jinteg.digest_fps(fps[keep])


def test_fixed_capacity_dedup_equals_the_reference():
    rng = np.random.default_rng(1)
    for cap, n, m in ((64, 10, 20), (256, 0, 50), (128, 100, 28)):
        pool = np.unique(rng.integers(-(2**62), 2**62, size=n + m + 50))
        rng.shuffle(pool)
        old = torch.from_numpy(np.sort(pool[:n]))
        new = torch.from_numpy(np.sort(pool[n : n + m]))
        keys = torch.cat([old, torch.full((cap - n,), dedup.PAD)])
        q = torch.from_numpy(np.concatenate([pool[: n // 2], pool[n : n + m]]))
        found, rank = dedup.rank_full(keys, q)
        r_found, r_rank = dedup.rank_sorted(keys, n, q)
        assert torch.equal(found, r_found) and torch.equal(rank, r_rank)
        nrank = dedup.rank_sorted(keys, n, new)[1]
        pad = torch.full((7,), dedup.PAD)
        got = dedup.merge_full(keys, torch.tensor(n), torch.cat([new, pad]),
                               torch.cat([nrank, torch.zeros(7, dtype=torch.int64)]),
                               torch.tensor(m))
        want, _ = dedup.merge_ranked(keys, n, new, nrank, cap)
        assert torch.equal(got, want)


def test_width_policy_and_level_new_sizing_equal_jax():
    _, tm = models(THW)
    jm, _ = models(THW)
    jstep = jbfs._Step(jm)
    rng = np.random.default_rng(2)
    for B in (32, 256, 4096, 32768):
        tp, jp = tpipeline.PooledWidths(tm.actions), jpipeline.PooledWidths(jm.actions)
        for _ in range(4):
            counts = rng.integers(0, B * 3, size=len(tm.actions)).astype(np.float64)
            want = jstep.norm_widths(B, jp.widths_for(B, counts, B))
            assert tp.widths_for(B, counts) == want
    for T, hw, worst in ((256, 0, 1024), (2816, 100_000, 1 << 20), (2816, 10, 1 << 20),
                         (1 << 17, 5 << 20, 1 << 24)):
        assert devlevel.level_new_capacity(T, hw, worst) == \
            jdevlevel.level_new_capacity(T, hw, worst)
        assert devlevel.level_new_bound(worst) == jdevlevel.level_new_bound(worst)


def test_chip_smoke_level_pins_equal_the_jax_plan():
    """chip_smoke.py's counts of levels run on the card equal the JAX
    package's plan_level, and the port's, over the pinned level sizes at
    check()'s default knobs."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    fused = types.SimpleNamespace(fallback=False, compact_shift=2, compact_gate=4096)
    fused._gate = lambda b: jpipeline.FusedPipeline._gate(fused, b)
    jplan = types.SimpleNamespace(device_fallback=None, fused=fused)
    tplan = tpipeline.DevicePipeline(models(THW)[1], "device", True, False, 2, 4096)
    tiny = np.convolve(np.convolve(pins.TINY_LEVELS, pins.TINY_LEVELS), pins.TINY_LEVELS)
    for levels, pinned in ((pins.KIP320_LEVELS, pins.KIP320_DEVICE_LEVELS),
                           (pins.THW_LEVELS, pins.THW_DEVICE_LEVELS),
                           (pins.ASYNC_4R_LEVELS, pins.ASYNC_4R_DEVICE_LEVELS),
                           (tiny.tolist(), pins.TINY_DEVICE_LEVELS)):
        want = [jpipeline.DevicePipeline.plan_level(jplan, f, 32768, 256) for f in levels]
        assert [tplan.plan_level(f, 32768, 256) for f in levels] == want
        assert sum(p is not None for p in want) == pinned


def test_cli_pipeline_device_record_equals_jax(capsys, monkeypatch):
    args = ["check", str(REPO / "configs" / "AsyncIsr.cfg"), "--cpu", "--json",
            "--pipeline", "device", "--min-bucket", "32", "--chunk-size", "256"]
    drop = ("seconds", "states_per_sec", "run_id")
    assert jcli.main(args) == 0
    want = {k: v for k, v in json.loads(capsys.readouterr().out.splitlines()[-1]).items()
            if k not in drop}
    assert cli.main(args) == 0
    got = {k: v for k, v in json.loads(capsys.readouterr().out.splitlines()[-1]).items()
           if k not in drop}
    assert got == want
    monkeypatch.setenv("KSPEC_PIPELINE", "device")
    assert cli.main(args[:-4]) == 0
