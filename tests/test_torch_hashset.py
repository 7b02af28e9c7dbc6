"""PyTorch port: the open-addressing table and the plain version of kernel
K2 against the JAX package (jnp claim lattice and both Pallas probe
kernels in interpret mode), on the shared probe fixture."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kafka_specification_tpu.ops import hashset as jhashset
from kafka_specification_tpu.ops.pallas_hashset import (
    probe_insert_pallas,
    probe_insert_pallas_hbm,
)
from kafka_specification_tpu.ops.probe_fixture import (
    assert_same_winners,
    live_set,
    make_probe_case,
)
from kafka_specification_tpu_torch import interop
from kafka_specification_tpu_torch.ops import cuda_hashset, hashset
from kafka_specification_tpu_torch.ops.dedup import pair_key

CPU = torch.device("cpu")


def port_case(case):
    """The fixture's inputs as the port's tensors (table seeded via interop)."""
    table = interop.table_from_jax(case["t_hi0"], case["t_lo0"], CPU)
    q = pair_key(interop.from_u32(case["q_hi"], CPU), interop.from_u32(case["q_lo"], CPU))
    valid = torch.from_numpy(np.array(case["valid"]))
    return table, q, valid


@pytest.mark.parametrize("seed", [5, 7])
def test_plain_probe_same_winners_as_jnp(seed):
    case = make_probe_case(seed=seed)
    table, q, valid = port_case(case)
    table, is_new, n_new, ovf = hashset.probe_insert(table, q, valid)
    assert not bool(ovf)
    t_hi, t_lo = interop.table_to_pairs(table)
    assert_same_winners(case, t_hi, t_lo, is_new.numpy(), int(n_new))
    # same algorithm as the jnp path: the same slots, not only the same set
    np.testing.assert_array_equal(t_hi, np.asarray(case["ref_hi"]))
    np.testing.assert_array_equal(t_lo, np.asarray(case["ref_lo"]))


def test_plain_probe_matches_pallas_kernels():
    case = make_probe_case(seed=11)
    table, q, valid = port_case(case)
    table, is_new, n_new, _ = hashset.probe_insert(table, q, valid)
    t_hi, t_lo = interop.table_to_pairs(table)
    for kern in (probe_insert_pallas, probe_insert_pallas_hbm):
        ph, plo, p_new, p_n, p_ovf = kern(
            case["t_hi0"], case["t_lo0"], case["q_hi"], case["q_lo"],
            case["valid"], block_rows=256, interpret=True,
        )
        assert not bool(p_ovf)
        np.testing.assert_array_equal(is_new.numpy(), np.asarray(p_new))
        assert int(n_new) == int(p_n)
        assert live_set(t_hi, t_lo) == live_set(ph, plo)


def test_wrapper_takes_plain_version_on_cpu():
    case = make_probe_case(seed=5)
    t1, q, valid = port_case(case)
    t2 = t1.clone()
    _, new1, n1, o1 = hashset.probe_insert(t1, q, valid)
    _, new2, n2, o2 = cuda_hashset.probe_insert(t2, q, valid)
    assert torch.equal(t1, t2) and torch.equal(new1, new2)
    assert int(n1) == int(n2) and bool(o1) == bool(o2)


def test_overflow_then_grow_and_rerun_gives_same_novelty():
    """A table far too small overflows; growing it and re-running the same
    batch, OR-ing novelty, gives the winners of a table that never
    overflowed (and of the JAX claim lattice)."""
    rng = np.random.default_rng(3)
    m = 400
    keys = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    keys[m // 2 :] = keys[rng.integers(0, m // 2, size=m - m // 2)]  # duplicates
    valid = rng.random(m) < 0.95
    q = pair_key(interop.from_u32(keys[:, 0], CPU), interop.from_u32(keys[:, 1], CPU))
    tv = torch.from_numpy(valid)

    table = hashset.new_table(16, CPU)
    isnew = torch.zeros(m, dtype=torch.bool)
    overflowed = 0
    while True:
        table, m_new, _n, ovf = hashset.probe_insert(table, q, tv)
        isnew |= m_new
        if not bool(ovf):
            break
        overflowed += 1
        table = hashset.rehash_into(table, 2 * table.shape[0])
    assert overflowed > 0

    _, ref_new, _, ovf = hashset.probe_insert(hashset.new_table(4096, CPU), q, tv)
    assert not bool(ovf)
    assert torch.equal(isnew, ref_new)
    jh, jl = jhashset.new_table(4096)
    _, _, _, j_new, _, _ = jhashset.probe_insert(
        jh, jl, jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]), jnp.asarray(valid)
    )
    np.testing.assert_array_equal(isnew.numpy(), np.asarray(j_new))
    # every valid key is a member exactly once
    hi, lo = hashset.live_pairs(table)
    assert len(hi) == len({tuple(k) for k in keys[valid].tolist()})


def test_table_from_pairs_matches_jax_slot_for_slot():
    rng = np.random.default_rng(9)
    pairs = np.unique(rng.integers(0, 2**32, size=(3000, 2), dtype=np.uint32), axis=0)
    jh, jl = jhashset.table_from_pairs(pairs[:, 0], pairs[:, 1], min_cap=1 << 12)
    table = hashset.table_from_pairs(
        interop.from_u32(pairs[:, 0], CPU),
        interop.from_u32(pairs[:, 1], CPU),
        min_cap=1 << 12,
    )
    t_hi, t_lo = interop.table_to_pairs(table)
    np.testing.assert_array_equal(t_hi, np.asarray(jh))
    np.testing.assert_array_equal(t_lo, np.asarray(jl))


def test_rehash_into_keeps_membership():
    rng = np.random.default_rng(4)
    pairs = np.unique(rng.integers(0, 2**32, size=(700, 2), dtype=np.uint32), axis=0)
    hi = interop.from_u32(pairs[:, 0], CPU)
    lo = interop.from_u32(pairs[:, 1], CPU)
    table = hashset.table_from_pairs(hi, lo, min_cap=1 << 10)
    grown = hashset.rehash_into(table, 1 << 13)
    assert grown.shape[0] == 1 << 13
    assert live_set(*interop.table_to_pairs(grown)) == live_set(*interop.table_to_pairs(table))
    # every key is found again: nothing new
    _, is_new, n_new, ovf = hashset.probe_insert(
        grown, pair_key(hi, lo), torch.ones(len(pairs), dtype=torch.bool)
    )
    assert int(n_new) == 0 and not bool(ovf) and not bool(is_new.any())


def test_new_table_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        hashset.new_table(12, CPU)


def test_kernel_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hashset.launch(
            hashset.new_table(16, CPU), torch.zeros(4, dtype=torch.int64),
            torch.ones(4, dtype=torch.uint8),
        )
