"""PyTorch port of the small models, IdSequence and FiniteReplicatedLog:
every action kernel gives the JAX package's (enabled, packed successor) on
every choice of random in-range states, and check() gives the JAX engine's
levels row for row, total, diameter and traces, on the three visited
backends (the tests/test_engine.py cases: MaxId + 2 states, FRL(3,4,1) = 125,
FRL(2,2,2) = 49 in exact and forced-hashed mode, the BelowBound trace
0 -> 4, a violation at Init)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models.base import Invariant as JInvariant
from kafka_specification_tpu_torch import check, interop
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models.base import Invariant as TInvariant
from torch_guards import overlap_guard  # noqa: F401  (autouse)

BACKENDS = ["device", "device-hash", "host"]


def model_pair(name, *args, **kw):
    mod = {"IdSequence": (jids, tids), "FRL": (jfrl, tfrl)}[name]
    return mod[0].make_model(*args, **kw), mod[1].make_model(*args, **kw)


def run_both(jm, tm, **kw):
    jl, tl = [], []
    jr = jbfs.check(jm, collect_levels=jl, min_bucket=32, **kw)
    tr = check(tm, device="cpu", collect_levels=tl, min_bucket=32, **kw)
    assert (tr.levels, tr.total, tr.diameter) == (jr.levels, jr.total, jr.diameter)
    for d, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(interop.to_u32(t), np.asarray(j), err_msg=f"level {d}")
    assert (tr.violation is None) == (jr.violation is None)
    if jr.violation is not None:
        assert (tr.violation.invariant, tr.violation.depth) == (jr.violation.invariant,
                                                                 jr.violation.depth)
        assert tr.violation.trace == jr.violation.trace
    return jr, tr


@pytest.mark.parametrize("name, args", [("IdSequence", (6,)), ("FRL", (3, 3, 2)),
                                        ("FRL", (2, 2, 2))])
def test_action_kernels_and_invariant_match_jax(name, args):
    jm, tm = model_pair(name, *args)
    assert [(a.name, a.n_choices) for a in tm.actions] == [(a.name, a.n_choices) for a in jm.actions]
    assert tm.name == jm.name and tm.spec.exact64 == jm.spec.exact64
    rng = np.random.default_rng(3)
    rand = {f.name: rng.integers(f.lo, f.hi + 1, size=(300, *f.shape)) for f in jm.spec.fields}
    rows = np.asarray(jax.vmap(jm.spec.pack)({k: jnp.asarray(v, jnp.int32) for k, v in rand.items()}))
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    for ja, ta in zip(jm.actions, tm.actions):
        @jax.jit
        def expand(s, a=ja):
            en, nxt = jax.vmap(
                lambda st: jax.vmap(lambda c: a.kernel(st, c))(jnp.arange(a.n_choices))
            )(s)
            return en, jax.vmap(jax.vmap(jm.spec.pack))(nxt)

        en, packed = expand(jstates)
        t_en, t_nxt = ta.kernel(tstates)
        np.testing.assert_array_equal(t_en.numpy(), np.asarray(en), err_msg=ja.name)
        np.testing.assert_array_equal(interop.to_u32(tm.spec.pack(t_nxt)), np.asarray(packed),
                                      err_msg=ja.name)
    want = np.asarray(jax.jit(jax.vmap(jm.invariants[0].pred))(jstates))
    got = tm.invariants[0].pred(tstates).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want.all() or name == "IdSequence"


@pytest.mark.parametrize("backend", BACKENDS)
def test_id_sequence_chain(backend):
    jr, tr = run_both(*model_pair("IdSequence", 10), visited_backend=backend)
    assert tr.ok and tr.total == 12 and tr.levels == [1] * 12


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("args, kw, total", [
    ((3, 4, 1), {}, 125),
    ((2, 2, 2), {}, 49),
    ((2, 2, 2), {"force_hashed": True}, 49),
])
def test_finite_replicated_log(args, kw, total, backend):
    jm, tm = model_pair("FRL", *args, **kw)
    assert tm.spec.exact64 == (not kw)
    _, tr = run_both(jm, tm, visited_backend=backend)
    assert tr.ok and tr.total == total


def _with_invariant(model, inv):
    return dataclasses.replace(model, invariants=[inv])


@pytest.mark.parametrize("backend", BACKENDS)
def test_below_bound_trace(backend):
    """BelowBound (nextId <= 3) on IdSequence(5): violated at depth 4 by
    state 4, trace 0 -> 1 -> 2 -> 3 -> 4 through NextId."""
    jm, tm = model_pair("IdSequence", 5)
    jm = _with_invariant(jm, JInvariant("BelowBound", lambda s: s["nextId"] <= 3))
    tm = _with_invariant(tm, TInvariant("BelowBound", lambda s: s["nextId"] <= 3))
    _, tr = run_both(jm, tm, visited_backend=backend)
    v = tr.violation
    assert (v.invariant, v.depth, v.state) == ("BelowBound", 4, 4)
    assert v.trace == [("<init>", 0)] + [("NextId", i) for i in range(1, 5)]


def test_violation_at_init():
    jm, tm = model_pair("IdSequence", 3)
    jm = _with_invariant(jm, JInvariant("NotZero", lambda s: s["nextId"] != 0))
    tm = _with_invariant(tm, TInvariant("NotZero", lambda s: s["nextId"] != 0))
    _, tr = run_both(jm, tm)
    assert tr.violation.depth == 0 and tr.violation.trace == [("<init>", 0)]
