"""PyTorch port of the random simulation mode (engine/simulate.py) against
the JAX package's, walk for walk on the same seed: the three scenarios of
tests/test_simulate.py (TruncateToHW breaking WeakIsr, Kip320 clean,
Kip101 deterministic under its seed), each with the visited count after
every walk, the total, the violation and its whole walk equal; plus the
edges of the draw order (the check of the last state at max_depth, depth
0, a deadlocked walk), a constraint, and an AsyncIsr and a product walk."""

import pytest

from kafka_specification_tpu.engine.simulate import simulate as jax_simulate
from kafka_specification_tpu.models import async_isr as jasync
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import product as jproduct
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu_torch import interop
from kafka_specification_tpu_torch.engine.simulate import simulate
from kafka_specification_tpu_torch.models import async_isr as tasync
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import product as tproduct
from kafka_specification_tpu_torch.models import variants as tvariants

from test_torch_product import jax_counters, port_counters

CFG = jkr.Config(2, 2, 1, 1)


def walk_both(jm, tm, **kw):
    """Both simulations; the visited count after each walk, the totals and
    the violations (with their walks) must be equal."""
    jw, tw = [], []
    jr = jax_simulate(jm, progress=lambda w, v: jw.append((w, v)), **kw)
    tr = simulate(tm, progress=lambda w, v: tw.append((w, v)), device="cpu", **kw)
    assert tw == jw
    assert (tr.total, tr.levels, tr.diameter, tr.model) == (jr.total, jr.levels, jr.diameter, jr.model)
    assert {k: tr.stats[k] for k in jr.stats} == jr.stats
    assert (tr.violation is None) == (jr.violation is None)
    if jr.violation is not None:
        assert (tr.violation.invariant, tr.violation.depth) == (jr.violation.invariant,
                                                                 jr.violation.depth)
        assert tr.violation.state == jr.violation.state
        assert tr.violation.trace == jr.violation.trace
    return jr, tr


def test_simulation_finds_known_violation():
    jm = jvariants.make_model("KafkaTruncateToHighWatermark", CFG, ("WeakIsr",))
    tm = tvariants.make_model("KafkaTruncateToHighWatermark", interop.config_from_jax(CFG),
                              ("WeakIsr",))
    _, tr = walk_both(jm, tm, num_walks=400, max_depth=30, seed=5)
    assert tr.violation.invariant == "WeakIsr"
    assert len(tr.violation.trace) == tr.violation.depth + 1


def test_simulation_clean_on_correct_protocol():
    _, tr = walk_both(jkip320.make_model(CFG), tkip320.make_model(interop.config_from_jax(CFG)),
                      num_walks=60, max_depth=30, seed=1)
    assert tr.ok and tr.total > 0 and tr.stats["mode"] == "simulate"


def test_simulation_deterministic_under_seed():
    jm = jvariants.make_model("Kip101", CFG, ("TypeOk",))
    tm = tvariants.make_model("Kip101", interop.config_from_jax(CFG), ("TypeOk",))
    _, r1 = walk_both(jm, tm, num_walks=20, max_depth=20, seed=9)
    r2 = simulate(tm, num_walks=20, max_depth=20, seed=9, device="cpu")
    assert r1.total == r2.total


@pytest.mark.parametrize("max_depth", [0, 1, 3, 6])
def test_depth_limit_checks_the_last_state(max_depth):
    """IdSequence(2) walks 0 -> 3 and deadlocks there; TypeOk never breaks,
    so every walk ends at the depth limit (one more state checked) or at
    the deadlock."""
    _, tr = walk_both(jids.make_model(2), tids.make_model(2), num_walks=3,
                      max_depth=max_depth, seed=0)
    per_walk = {0: 1, 1: 2, 3: 4, 6: 4}[max_depth]
    assert tr.ok and tr.total == 3 * per_walk


def test_constraint_prunes_the_draw():
    """Every successor of (2, 2) and of (3, 1) breaks the constraint: each
    walk ends at one of them, at depth 4, as a deadlock, in both
    packages."""
    _, tr = walk_both(jax_counters(4), port_counters(4), num_walks=30, max_depth=10, seed=3)
    assert tr.ok and tr.total == 30 * 5


def test_async_isr_and_product_walks():
    jc = jasync.AsyncIsrConfig(3, 2, 2)
    walk_both(jasync.make_model(jc), tasync.make_model(interop.async_isr_config_from_jax(jc)),
              num_walks=8, max_depth=25, seed=4)
    jm = jproduct.product_model(jids.make_model(3), 3)
    tm = tproduct.product_model(tids.make_model(3), 3)
    _, tr = walk_both(jm, tm, num_walks=5, max_depth=20, seed=2)
    assert tr.ok and tr.total == 5 * (3 * 4 + 1)  # 12 steps to the deadlock at (4, 4, 4)
