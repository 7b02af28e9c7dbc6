"""PyTorch port of AsyncIsr (models/async_isr.py) against the JAX package,
with zero tolerance: every action's enabled mask and packed successor,
cell for cell, on the states of JAX's levels carried across with
interop.from_u32 (and random in-range states); the invariants and the
decoder; check() on AsyncIsr 2r, 3r M2 V2 (4,088 states, diameter 16)
and 3r M3 V3 (48,120, diameter 23): levels, total, diameter, the
per-level stats lines and the digest chain, on the device, device-hash
and host backends with the fused and legacy pipelines; the .cfg front
end, with its refusal of 5 replicas and of CONSTRAINT elsewhere; and the
trace renderer.  4r M2 V2 is tests/test_torch_async_isr_4r.py."""

import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import async_isr as jasync
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu.utils import pretty as jpretty
from kafka_specification_tpu_torch import build_model, check, interop, load_config
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
from kafka_specification_tpu_torch.models import async_isr as tasync
from kafka_specification_tpu_torch.models.base import EncodingUnsound
from kafka_specification_tpu_torch.utils import cfg as tcfg
from kafka_specification_tpu_torch.utils import pretty
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
BACKENDS = ["device", "device-hash", "host"]
PIPELINES = ["fused", "legacy"]
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement")
# (replicas, MaxOffset, MaxVersion) -> (states, diameter)
CONFIGS = {(2, 2, 2): (84, 11), (3, 2, 2): (4088, 16), (3, 3, 3): (48120, 23)}


def pair(n, m, v, invariants=tasync.DEFAULT_INVARIANTS):
    jc = jasync.AsyncIsrConfig(n, m, v)
    return (jasync.make_model(jc, invariants),
            tasync.make_model(interop.async_isr_config_from_jax(jc), invariants))


def stats_lines(path):
    with open(path) as fh:
        return [{k: json.loads(line)[k] for k in DETERMINISTIC} for line in fh]


def chain_of(directory):
    return jckpt.verify_file(str(Path(directory) / CHECKPOINT_BASENAME))["digest_chain"]


_JAX: dict = {}


def jax_run(cfg, tmp_path_factory):
    """One JAX check per config (its levels, chain and stats lines do not
    depend on the knobs), with every level's rows collected."""
    if cfg not in _JAX:
        d = tmp_path_factory.mktemp("jax")
        jm, _ = pair(*cfg)
        levels = []
        res = jbfs.check(jm, checkpoint_dir=str(d / "ck"), checkpoint_keep=1,
                         stats_path=str(d / "stats.jsonl"), visited_backend="host",
                         min_bucket=4096, chunk_size=4096,
                         collect_levels=levels)
        _JAX[cfg] = (res, chain_of(d / "ck"), stats_lines(d / "stats.jsonl"),
                     np.concatenate([np.asarray(x) for x in levels]))
    return _JAX[cfg]


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cfg", list(CONFIGS), ids=lambda c: "%dr-M%d-V%d" % c)
def test_check_equals_jax(cfg, backend, pipeline, tmp_path, tmp_path_factory):
    jr, jchain, jstats, _ = jax_run(cfg, tmp_path_factory)
    jm, tm = pair(*cfg)
    tr = check(tm, device="cpu", visited_backend=backend, pipeline=pipeline,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_keep=1,
               stats_path=str(tmp_path / "stats.jsonl"))
    assert (tr.total, tr.diameter) == CONFIGS[cfg]
    assert (tr.levels, tr.total, tr.diameter, tr.ok) == (jr.levels, jr.total, jr.diameter, True)
    np.testing.assert_array_equal(chain_of(tmp_path / "ck"), jchain)
    assert stats_lines(tmp_path / "stats.jsonl") == jstats
    assert tr.stats["lanes"] == tm.spec.num_lanes == jm.spec.num_lanes


def test_check_with_a_trace_equals_jax():
    """The default knobs with the trace kept: levels row for row."""
    jm, tm = pair(3, 2, 2)
    jl, tl = [], []
    jr = jbfs.check(jm, collect_levels=jl)
    tr = check(tm, device="cpu", collect_levels=tl)
    assert tr.levels == jr.levels
    for d, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(interop.to_u32(t), np.asarray(j), err_msg=f"level {d}")


def _random_rows(jm, n, seed):
    rng = np.random.default_rng(seed)
    rand = {f.name: jnp.asarray(rng.integers(f.lo, f.hi + 1, size=(n, *f.shape)), jnp.int32)
            for f in jm.spec.fields}
    return np.asarray(jax.vmap(jm.spec.pack)(rand))


@pytest.mark.parametrize("cfg", [(3, 2, 2), (3, 3, 3)], ids=["3r-M2-V2", "3r-M3-V3"])
def test_action_kernels_match_jax(cfg, tmp_path_factory):
    """Every action, every choice, on every state JAX reached (a sample of
    3r M3 V3's) and on random in-range states."""
    _, _, _, rows = jax_run(cfg, tmp_path_factory)
    jm, tm = pair(*cfg)
    rows = np.concatenate([rows[:: max(1, len(rows) // 4000)], _random_rows(jm, 512, 7)])
    assert [(a.name, a.n_choices) for a in tm.actions] == [(a.name, a.n_choices) for a in jm.actions]
    n = cfg[0]
    assert [a.n_choices for a in tm.actions] == [n, 1 << n, n, n, 1, cfg[2] + 1, n]
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    for ja, ta in zip(jm.actions, tm.actions):
        @jax.jit
        def expand(s, a=ja):
            en, nxt = jax.vmap(
                lambda st: jax.vmap(lambda c: a.kernel(st, c))(jnp.arange(a.n_choices))
            )(s)
            return en, jax.vmap(jax.vmap(jm.spec.pack))(nxt)

        j_en, j_packed = map(np.asarray, expand(jstates))
        t_en, t_nxt = ta.kernel(tstates)
        np.testing.assert_array_equal(t_en.numpy(), j_en, err_msg=ja.name)
        assert j_en.any(), ja.name
        np.testing.assert_array_equal(
            interop.to_u32(tm.spec.pack(t_nxt)), j_packed, err_msg=ja.name
        )


def test_invariants_and_decode_match_jax(tmp_path_factory):
    _, _, _, rows = jax_run((3, 2, 2), tmp_path_factory)
    jm, tm = pair(3, 2, 2)
    rows = np.concatenate([rows, _random_rows(jm, 1024, 8)])
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    for ji, ti in zip(jm.invariants, tm.invariants):
        assert ti.name == ji.name
        want = np.asarray(jax.jit(jax.vmap(ji.pred))(jstates))
        np.testing.assert_array_equal(ti.pred(tstates).numpy(), want, err_msg=ji.name)
    # TypeOk holds on in-range fields by construction; the random rows
    # break ValidHighWatermark somewhere, so both of its outcomes occur
    assert not tm.invariants[1].pred(tstates).all()
    for row in rows[::37]:
        js = {k: np.asarray(v) for k, v in jm.spec.unpack(jnp.asarray(row)).items()}
        ts = {k: v.numpy() for k, v in tm.spec.unpack(interop.from_u32(row, "cpu")).items()}
        assert tm.decode(ts) == jm.decode(js)
        meta = {"variant": "AsyncIsr", "replica_names": ["b1", "b2", "b3"]}
        for m in (meta, {"variant": "AsyncIsr"}):
            assert pretty.render_state(m, jm.decode(js)) == jpretty.render_state(m, jm.decode(js))


def test_spec_and_init_equal_jax():
    for n, m, v in [(1, 1, 1), (2, 3, 1), (4, 3, 3)]:
        jm, tm = pair(n, m, v)
        assert tm.name == jm.name
        assert [(f.name, f.shape, f.lo, f.hi) for f in tm.spec.fields] == [
            (f.name, f.shape, f.lo, f.hi) for f in jm.spec.fields]
        assert tm.spec.num_lanes == jm.spec.num_lanes
        assert tm.init_states() == jm.init_states()
        assert tm.constraint is None and jm.constraint is None
    assert pair(4, 3, 3)[1].spec.num_lanes == 4


def test_five_replicas_refused_with_the_jax_message():
    with pytest.raises(ValueError) as jerr:
        jasync.make_model(jasync.AsyncIsrConfig(5, 2, 2))
    with pytest.raises(EncodingUnsound) as terr:
        tasync.make_model(tasync.AsyncIsrConfig(5, 2, 2))
    assert str(terr.value) == str(jerr.value)
    assert "at most 4 replicas, got 5" in str(terr.value)
    cfg = load_config(REPO / "configs" / "AsyncIsr.cfg")
    cfg.constants["Replicas"] = ["b1", "b2", "b3", "b4", "b5"]
    with pytest.raises(ValueError, match="at most 4 replicas"):
        build_model("AsyncIsr", cfg)


def test_cfg_builds_the_jax_model():
    path = REPO / "configs" / "AsyncIsr.cfg"
    tc, jc = load_config(path), jcfg.parse_cfg(path)
    assert tc.constraints == jc.constraints == ["Bounded"]
    tm = build_model("AsyncIsr", tc)
    jm = jcfg.build_model("AsyncIsr", jc, analysis_gate=False)
    assert tm.name == jm.name == "AsyncIsr(3r,M2,V2)"
    assert [i.name for i in tm.invariants] == [i.name for i in jm.invariants]
    assert tm.meta["replica_names"] == jm.meta["replica_names"] == ["b1", "b2", "b3"]
    # MaxVersion defaults to MaxOffset; the invariants to TypeOk, ValidHighWatermark
    for c in (tc, jc):
        del c.constants["MaxVersion"]
        c.invariants = []
    assert build_model("AsyncIsr", tc).name == jcfg.build_model(
        "AsyncIsr", jc, analysis_gate=False).name == "AsyncIsr(3r,M2,V2)"
    for module in ("AsyncIsr", "Kip320", "IdSequence", "KafkaTruncateToHighWatermark"):
        assert tcfg.resolved_invariants(module, tc) == jcfg.resolved_invariants(module, jc)
    with pytest.raises(KeyError):
        tcfg.resolved_invariants("Nope", tc)


def test_constraint_refused_outside_async_isr():
    path = REPO / "configs" / "Kip320.cfg"
    tc, jc = load_config(path), jcfg.parse_cfg(path)
    tc.constraints = jc.constraints = ["Bounded"]
    with pytest.raises(ValueError) as jerr:
        jcfg.build_model("Kip320", jc, analysis_gate=False)
    with pytest.raises(ValueError) as terr:
        build_model("Kip320", tc)
    assert str(terr.value) == str(jerr.value)
