"""PyTorch port of the partition product (models/product.py) and of
Model.constraint against the JAX package, with zero tolerance:

- IdSequence(2)^3 = 64 states, and TINY^2 (Kip320 2r L2 R1 E1, two
  partitions) cut at depth 8: levels row for row, total, the digest chain;
- TINY^2 to the end against the closed form: the levels are the
  convolution of the base's levels (76,729 = 277^2 states, diameter 22);
- the mixed product TINY x IdSequence(2) = 277 x 4;
- a product violation (TruncateToHW 2r WeakIsr x 2): its trace, value for
  value, and its rendering; with no knobs, the JAX trace chip_smoke.py pins;
- each lifted action against its base kernel on its partition's fields;
- an ad-hoc model with a constraint, alone and in a product, with
  check_deadlock=True: the pruned successors are not explored or counted,
  the per-level enablement counts are taken after the constraint, and a
  deadlock is judged on the mask before it;
- the .cfg front end: Kip320Stretch.cfg (Partitions = 3) builds JAX's
  product."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import base as jbase
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import product as jproduct
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.ops import packing as jpacking
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu.utils import pretty as jpretty
from kafka_specification_tpu_torch import build_model, check, interop, load_config
from kafka_specification_tpu_torch.models import base as tbase
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import product as tproduct
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.ops import packing as tpacking
from kafka_specification_tpu_torch.utils import pretty

from test_torch_async_isr import chain_of, stats_lines
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY = (2, 2, 1, 1)
TINY_LEVELS = [1, 4, 12, 18, 36, 44, 48, 48, 30, 22, 12, 2]
# one chunk shape, the full lattice's order and a fixed sorted-set size: the
# JAX engine compiles each product model's level step once (its step cache
# is kept per model object, so the JAX models below are made once)
ONE_SHAPE = dict(min_bucket=1024, chunk_size=1024, compact_shift=0,
                 visited_capacity_exact=1 << 17)


def tiny(invariants=("TypeOk",)):
    jc = jkr.Config(*TINY)
    return (jkip320.make_model(jc, invariants),
            tkip320.make_model(interop.config_from_jax(jc), invariants))


def run_both(jm, tm, tmp_path, **kw):
    """Both checks with the levels collected, a checkpoint (for the chain)
    and the stats lines; -> (JAX result, port result)."""
    jl, tl = [], []
    jr = jbfs.check(jm, collect_levels=jl, checkpoint_dir=str(tmp_path / "jck"),
                    checkpoint_keep=1, stats_path=str(tmp_path / "j.jsonl"), **kw)
    tr = check(tm, device="cpu", collect_levels=tl, checkpoint_dir=str(tmp_path / "tck"),
               checkpoint_keep=1, stats_path=str(tmp_path / "t.jsonl"), **kw)
    assert (tr.levels, tr.total, tr.diameter, tr.ok) == (jr.levels, jr.total, jr.diameter, jr.ok)
    for d, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(interop.to_u32(t), np.asarray(j), err_msg=f"level {d}")
    np.testing.assert_array_equal(chain_of(tmp_path / "tck"), chain_of(tmp_path / "jck"))
    assert stats_lines(tmp_path / "t.jsonl") == stats_lines(tmp_path / "j.jsonl")
    return jr, tr


def test_id_sequence_cubed(tmp_path):
    jm = jproduct.product_model(jids.make_model(2), 3)
    tm = tproduct.product_model(tids.make_model(2), 3)
    assert tm.name == jm.name
    assert [(a.name, a.n_choices) for a in tm.actions] == [(a.name, a.n_choices) for a in jm.actions]
    assert [(f.name, f.shape, f.lo, f.hi) for f in tm.spec.fields] == [
        (f.name, f.shape, f.lo, f.hi) for f in jm.spec.fields]
    assert tm.init_states() == jm.init_states()
    _, tr = run_both(jm, tm, tmp_path, min_bucket=32)
    assert tr.total == 64 and tr.levels == np.convolve(np.convolve([1] * 4, [1] * 4), [1] * 4).tolist()


def test_tiny_squared_cut_at_depth_8(tmp_path):
    (jb, tb) = tiny()
    jm, tm = jproduct.product_model(jb, 2), tproduct.product_model(tb, 2)
    assert len(tm.actions) == 18 and tm.meta == {**tb.meta, "partitions": 2, "base": tb.name}
    _, tr = run_both(jm, tm, tmp_path, max_depth=8, **ONE_SHAPE)
    assert tr.levels == np.convolve(TINY_LEVELS, TINY_LEVELS)[:9].tolist()


def test_tiny_squared_to_the_end_is_the_closed_form():
    _, tb = tiny()
    res = check(tproduct.product_model(tb, 2), device="cpu", store_trace=False)
    assert res.ok and res.total == 277 ** 2 == 76729 and res.diameter == 22
    assert res.levels == np.convolve(TINY_LEVELS, TINY_LEVELS).tolist()


def test_mixed_product(tmp_path):
    (jb, tb) = tiny()
    jm = jproduct.product_models([jb, jids.make_model(2)])
    tm = tproduct.product_models([tb, tids.make_model(2)])
    assert tm.name == jm.name and tm.meta["base"] == jm.meta["base"]
    _, tr = run_both(jm, tm, tmp_path, visited_backend="host", min_bucket=256)
    assert tr.total == 277 * 4
    assert tr.levels == np.convolve(TINY_LEVELS, [1] * 4).tolist()


def test_product_violation_trace_equals_jax():
    jc = jkr.Config(2, 2, 1, 1)
    jb = jvariants.make_model("KafkaTruncateToHighWatermark", jc, ("TypeOk", "WeakIsr"))
    tb = tvariants.make_model("KafkaTruncateToHighWatermark", interop.config_from_jax(jc),
                              ("TypeOk", "WeakIsr"))
    jm, tm = jproduct.product_model(jb, 2), tproduct.product_model(tb, 2)
    jr = jbfs.check(jm, **ONE_SHAPE)
    tr = check(tm, device="cpu", **ONE_SHAPE)
    assert jr.violation is not None and jr.violation.invariant == "WeakIsr"
    assert (tr.levels, tr.total) == (jr.levels, jr.total)
    assert (tr.violation.invariant, tr.violation.depth) == (jr.violation.invariant,
                                                             jr.violation.depth)
    assert tr.violation.trace == jr.violation.trace
    assert tr.violation.trace[1][0].startswith("p")
    meta = {**tm.meta, "replica_names": ["b1", "b2"]}
    assert pretty.render_trace(meta, tr.violation.trace) == jpretty.render_trace(
        meta, jr.violation.trace)
    assert "partition 1:" in pretty.render_state(tm.meta, tr.violation.state)


def test_product_violation_default_knobs_equals_the_jax_pin():
    """With no knobs (the sorted set, fused, the compact order above the
    gate: action-major over 18 lifted actions) the port gives the trace
    chip_smoke.py pins from the JAX package's run of the same model."""
    import hashlib
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    tb = tvariants.make_model("KafkaTruncateToHighWatermark", interop.config_from_jax(
        jkr.Config(2, 2, 1, 1)), ("TypeOk", "WeakIsr"))
    tr = check(tproduct.product_model(tb, 2), device="cpu")
    assert (tr.levels, tr.total) == (pins.PRODUCT_VIOLATION_LEVELS, 15997)
    assert [a for a, _ in tr.violation.trace] == pins.PRODUCT_VIOLATION_ACTIONS
    sha = hashlib.sha256(json.dumps(pins.canon(tr.violation.trace)).encode()).hexdigest()
    assert sha == pins.PRODUCT_VIOLATION_SHA


def test_lifted_kernel_is_the_base_kernel_on_its_partition():
    """A lifted action writes its partition's fields as the base kernel
    does and carries the other partitions' fields over unchanged."""
    _, tb = tiny()
    tm = tproduct.product_model(tb, 3)
    levels = []
    check(tm, device="cpu", max_depth=4, store_trace=False, collect_levels=levels)
    states = tm.spec.unpack(torch.cat(levels))
    for i, ta in enumerate(tm.actions):
        p, base = divmod(i, len(tb.actions))
        sub = {f.name: states[f"p{p}.{f.name}"] for f in tb.spec.fields}
        b_en, b_nxt = tb.actions[base].kernel(sub)
        en, nxt = ta.kernel(states)
        assert ta.name == f"p{p}.{tb.actions[base].name}"
        assert torch.equal(en, b_en)
        for key, v in nxt.items():
            q, name = key.split(".", 1)
            want = b_nxt[name] if q == f"p{p}" else states[key].unsqueeze(1).expand_as(v)
            assert torch.equal(v, want), (ta.name, key)


# --- Model.constraint --------------------------------------------------------
# Two counters, IncX (x < 3) and IncY (y < x), with the constraint
# x + y <= bound.  At bound 4, (3, 1) has IncY's guard on but its successor
# (3, 2) pruned: deadlocked after the constraint, not before it, so no
# deadlock is reported.  At bound 6, (3, 3) is reached and has no guard on.


def jax_counters(bound):
    spec = jpacking.StateSpec([jpacking.Field("x", (), 0, 3), jpacking.Field("y", (), 0, 3)])
    inc_x = jbase.Action("IncX", 1, lambda s, c: (s["x"] < 3, {**s, "x": jnp.minimum(s["x"] + 1, 3)}))
    inc_y = jbase.Action("IncY", 1, lambda s, c: (s["y"] < s["x"], {**s, "y": jnp.minimum(s["y"] + 1, 3)}))
    return jbase.Model(
        name=f"Counters({bound})", spec=spec, init_states=lambda: [{"x": 0, "y": 0}],
        actions=[inc_x, inc_y], invariants=[jbase.Invariant("TypeOk", lambda s: s["x"] >= 0)],
        constraint=lambda s: s["x"] + s["y"] <= bound,
        decode=lambda s: (int(s["x"]), int(s["y"])),
    )


def port_counters(bound):
    spec = tpacking.StateSpec([tpacking.Field("x", (), 0, 3), tpacking.Field("y", (), 0, 3)])

    def inc(name, guard):
        def kernel(s):
            x, y = s["x"].unsqueeze(1), s["y"].unsqueeze(1)
            nxt = {"x": x, "y": y}
            nxt[name] = (nxt[name] + 1).clamp(max=3)
            return guard(x, y), nxt

        return kernel

    return tbase.Model(
        name=f"Counters({bound})", spec=spec, init_states=lambda: [{"x": 0, "y": 0}],
        actions=[tbase.Action("IncX", 1, inc("x", lambda x, y: x < 3)),
                 tbase.Action("IncY", 1, inc("y", lambda x, y: y < x))],
        invariants=[tbase.Invariant("TypeOk", lambda s: s["x"] >= 0)],
        constraint=lambda s: s["x"] + s["y"] <= bound,
        decode=lambda s: (int(s["x"]), int(s["y"])),
    )


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_constraint_prunes_and_deadlock_reads_the_guards(backend, tmp_path):
    jr, tr = run_both(jax_counters(4), port_counters(4), tmp_path, check_deadlock=True,
                      visited_backend=backend, min_bucket=32)
    # (x, y) with y <= x <= 3 and x + y <= 4: 8 states, none deadlocked
    # before the constraint
    assert tr.ok and tr.total == 8 and tr.levels == [1, 1, 2, 2, 2]
    last = stats_lines(tmp_path / "t.jsonl")[-1]
    assert last["action_enablement"] == {"IncX": 0, "IncY": 0}  # (3, 1)'s IncY pruned
    # without the constraint (3, 3) is reached: no guard holds there
    jr, tr = run_both(jax_counters(6), port_counters(6), tmp_path / "six", check_deadlock=True,
                      visited_backend=backend, min_bucket=32)
    assert tr.violation.invariant == jr.violation.invariant == "Deadlock"
    assert tr.violation.trace == jr.violation.trace
    assert tr.violation.state == (3, 3)


def test_constraint_of_a_product(tmp_path):
    jm = jproduct.product_models([jax_counters(4), jids.make_model(1)])
    tm = tproduct.product_models([port_counters(4), tids.make_model(1)])
    probe = {k: torch.tensor([[0, 3]]).reshape(1, 2) for k in ("p0.x", "p0.y", "p1.nextId")}
    assert tm.constraint(probe).tolist() == [[True, False]]
    _, tr = run_both(jm, tm, tmp_path, check_deadlock=True, min_bucket=32)
    assert tr.ok and tr.total == 8 * 3
    assert jproduct.product_model(jids.make_model(1), 2).constraint is None
    assert tproduct.product_model(tids.make_model(1), 2).constraint is None


def test_stretch_cfg_builds_the_jax_product():
    path = REPO / "configs" / "Kip320Stretch.cfg"
    tm = build_model("Kip320", load_config(path))
    jm = jcfg.build_model("Kip320", jcfg.parse_cfg(path), analysis_gate=False)
    assert tm.name == jm.name == "Kip320(5r,L2,R2,E2) x3partitions"
    assert [(a.name, a.n_choices) for a in tm.actions] == [(a.name, a.n_choices) for a in jm.actions]
    assert len(tm.actions) == 27
    assert [(f.name, f.shape, f.lo, f.hi) for f in tm.spec.fields] == [
        (f.name, f.shape, f.lo, f.hi) for f in jm.spec.fields]
    assert tm.spec.num_lanes == jm.spec.num_lanes
    assert [i.name for i in tm.invariants] == [i.name for i in jm.invariants]
    for key in ("partitions", "base", "variant", "replica_names"):
        assert tm.meta[key] == jm.meta[key], key
    assert tm.init_states() == jm.init_states()
