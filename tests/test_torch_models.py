"""PyTorch port: every batched action kernel gives the (enabled, packed
successor) of the JAX package's vmapped kernel on every choice, and every
invariant agrees, over states the JAX engine reached plus random in-range
states; the .cfg front end builds the same models."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_specification_tpu.engine.bfs import check as jax_check
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu_torch import build_model, interop, load_config
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants

CONSTS = (2, 2, 2, 2)
ALL_INVARIANTS = ("TypeOk", "LeaderInIsr", "LeaderInIsrLiteral", "WeakIsr", "StrongIsr")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rows():
    """Packed uint32 rows: the first 8 BFS levels JAX reaches on Kip320 2r,
    then 512 random in-range states from a numpy seed."""
    levels = []
    jax_check(
        jkip320.make_model(jkr.Config(*CONSTS)),
        max_depth=8,
        visited_backend="device-hash",
        pipeline="legacy",
        compact_shift=0,
        store_trace=False,
        collect_levels=levels,
    )
    spec = jkr.make_spec(jkr.Config(*CONSTS))
    rng = np.random.default_rng(20)
    rand = {
        f.name: jnp.asarray(rng.integers(f.lo, f.hi + 1, size=(512, *f.shape)), jnp.int32)
        for f in spec.fields
    }
    return np.concatenate([np.concatenate(levels), np.asarray(jax.vmap(spec.pack)(rand))])


def model_pair(name):
    jc = jkr.Config(*CONSTS)
    tc = interop.config_from_jax(jc)
    if name == "Kip320":
        return jkip320.make_model(jc, ALL_INVARIANTS), tkip320.make_model(tc, ALL_INVARIANTS)
    if name == "Kip320FirstTry":
        return (
            jkip320.make_first_try_model(jc, ALL_INVARIANTS),
            tkip320.make_first_try_model(tc, ALL_INVARIANTS),
        )
    return (
        jvariants.make_model(name, jc, ALL_INVARIANTS),
        tvariants.make_model(name, tc, ALL_INVARIANTS),
    )


# every action of Kip320 and TruncateToHW; of the others, the actions they
# do not share with those two
CASES = [
    ("Kip320", None),
    ("KafkaTruncateToHighWatermark", None),
    ("Kip101", {"BecomeFollowerTruncateKip101"}),
    ("Kip279", {"BecomeFollowerTruncateKip279"}),
    (
        "Kip320FirstTry",
        {
            "LeaderExpandIsrBetterFencing", "LeaderShrinkIsrBetterFencing",
            "ImprovedLeaderIncHighWatermark", "BecomeFollower", "FollowerFetch",
            "FollowerTruncate",
        },
    ),
]


@pytest.mark.parametrize("name,only", CASES, ids=[c[0] for c in CASES])
def test_action_kernels_match_jax(rows, name, only):
    jm, tm = model_pair(name)
    assert [a.name for a in tm.actions] == [a.name for a in jm.actions]
    assert [a.n_choices for a in tm.actions] == [a.n_choices for a in jm.actions]
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    checked = 0
    for ja, ta in zip(jm.actions, tm.actions):
        if only is not None and ja.name not in only:
            continue

        @jax.jit
        def expand(s, a=ja):
            en, nxt = jax.vmap(
                lambda st: jax.vmap(lambda c: a.kernel(st, c))(jnp.arange(a.n_choices))
            )(s)
            return en, jax.vmap(jax.vmap(jm.spec.pack))(nxt)

        j_en, j_packed = expand(jstates)
        t_en, t_nxt = ta.kernel(tstates)
        np.testing.assert_array_equal(t_en.numpy(), np.asarray(j_en), err_msg=ja.name)
        np.testing.assert_array_equal(
            interop.to_u32(tm.spec.pack(t_nxt)), np.asarray(j_packed), err_msg=ja.name
        )
        checked += 1
    assert checked == (len(jm.actions) if only is None else len(only))


def test_invariants_match_jax(rows):
    jm, tm = model_pair("Kip320")
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    for ji, ti in zip(jm.invariants, tm.invariants):
        assert ti.name == ji.name
        want = np.asarray(jax.jit(jax.vmap(ji.pred))(jstates))
        np.testing.assert_array_equal(ti.pred(tstates).numpy(), want, err_msg=ji.name)
    # the random rows break every invariant somewhere: both outcomes occur
    assert not tm.invariants[-1].pred(tstates).all()


def test_decode_matches_jax(rows):
    jm, tm = model_pair("Kip320")
    for row in rows[:: max(1, len(rows) // 50)]:
        js = {k: np.asarray(v) for k, v in jm.spec.unpack(jnp.asarray(row)).items()}
        ts = {k: v.numpy() for k, v in tm.spec.unpack(interop.from_u32(row, "cpu")).items()}
        assert tm.decode(ts) == jm.decode(js)


@pytest.mark.parametrize(
    "module", ["Kip320", "Kip320FirstTry", "KafkaTruncateToHighWatermark", "Kip101", "Kip279",
               "IdSequence", "FiniteReplicatedLog", "AsyncIsr"]
)
def test_cfg_builds_the_same_model(module):
    path = REPO / "configs" / f"{module}.cfg"
    tcfg, jc = load_config(path), jcfg.parse_cfg(path)
    assert (tcfg.constants, tcfg.invariants, tcfg.check_deadlock) == (
        jc.constants, jc.invariants, jc.check_deadlock,
    )
    tm = build_model(module, tcfg)
    jm = jcfg.build_model(module, jc, analysis_gate=False)
    assert tm.name == jm.name
    assert [(a.name, a.n_choices) for a in tm.actions] == [
        (a.name, a.n_choices) for a in jm.actions
    ]
    assert [i.name for i in tm.invariants] == [i.name for i in jm.invariants]
    assert [(f.name, f.shape, f.lo, f.hi) for f in tm.spec.fields] == [
        (f.name, f.shape, f.lo, f.hi) for f in jm.spec.fields
    ]
    assert tm.meta.get("variant") == jm.meta.get("variant")
    assert tm.meta.get("replica_names") == jm.meta.get("replica_names")


def test_cfg_rejects_unported_modules():
    """Every module of the hand-written corpus is ported (AsyncIsr and the
    Partitions product included); a module outside it is refused, and so
    is a CONSTRAINT for a module other than AsyncIsr, as in the JAX
    package."""
    cfg = load_config(REPO / "configs" / "AsyncIsr.cfg")
    with pytest.raises(KeyError, match="^\"unknown module 'AlterPartition'\"$"):
        build_model("AlterPartition", cfg)
    assert build_model("AsyncIsr", cfg).name == "AsyncIsr(3r,M2,V2)"
    stretch = load_config(REPO / "configs" / "Kip320Stretch.cfg")
    assert build_model("Kip320", stretch).meta["partitions"] == 3
    stretch.constraints = ["Bounded"]
    with pytest.raises(ValueError, match="only AsyncIsr's bound"):
        build_model("Kip320", stretch)
