"""PyTorch port: the lane packer equals the JAX package's, bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.ops import packing as jpacking
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.ops import packing as tpacking

CONFIGS = [(2, 2, 2, 2), (3, 2, 2, 2), (2, 2, 1, 1)]


def random_states(spec, n, seed):
    """n random in-range states of a JAX StateSpec, as int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        f.name: rng.integers(f.lo, f.hi + 1, size=(n, *f.shape)).astype(np.int32)
        for f in spec.fields
    }


@pytest.mark.parametrize("consts", CONFIGS)
def test_pack_matches_jax_and_round_trips(consts):
    jspec = jkr.make_spec(jkr.Config(*consts))
    tspec = tkr.make_spec(tkr.Config(*consts))
    assert tspec.num_lanes == jspec.num_lanes
    assert tspec.exact64 == jspec.exact64
    assert tspec.total_bits == jspec.total_bits

    states = random_states(jspec, 512, seed=sum(consts))
    want = np.asarray(jax.vmap(jspec.pack)({k: jnp.asarray(v) for k, v in states.items()}))
    tstates = {k: torch.from_numpy(v.astype(np.int64)) for k, v in states.items()}
    got = tspec.pack(tstates)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

    back = tspec.unpack(got)
    for k, v in states.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_pack_with_extra_batch_dims():
    tspec = tkr.make_spec(tkr.Config(2, 2, 2, 2))
    jspec = jkr.make_spec(jkr.Config(2, 2, 2, 2))
    states = random_states(jspec, 24, seed=3)
    flat = tspec.pack({k: torch.from_numpy(v.astype(np.int64)) for k, v in states.items()})
    grid = tspec.pack(
        {k: torch.from_numpy(v.astype(np.int64)).reshape(4, 6, *v.shape[1:])
         for k, v in states.items()}
    )
    assert grid.shape == (4, 6, tspec.num_lanes)
    np.testing.assert_array_equal(grid.reshape(24, -1).numpy(), flat.numpy())


@pytest.mark.parametrize(
    "widths,force_hashed",
    [((16, 16, 16, 16), False), ((16, 16, 16, 15), False), ((8,), True), ((32, 32, 1), False)],
)
def test_exact64_rule_matches_jax(widths, force_hashed):
    """Two full lanes whose spans reach all-ones demote to hashed mode."""
    jf = [jpacking.Field(f"f{i}", (), 0, (1 << w) - 1) for i, w in enumerate(widths)]
    tf = [tpacking.Field(f"f{i}", (), 0, (1 << w) - 1) for i, w in enumerate(widths)]
    js = jpacking.StateSpec(jf, force_hashed=force_hashed)
    ts = tpacking.StateSpec(tf, force_hashed=force_hashed)
    assert (ts.num_lanes, ts.exact64) == (js.num_lanes, js.exact64)
