"""PyTorch port: the unsigned pair sort and first-occurrence marking equal
the JAX package's jnp.lexsort((lo, hi)) and dedup.first_occurrence_mask;
the sorted visited set's rank_sorted, member_sorted and merge_ranked equal
the JAX package's on the same pairs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kafka_specification_tpu.ops import dedup as jdedup
from kafka_specification_tpu_torch.ops import dedup


def pairs(m, seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    hi[: m // 4] = rng.choice([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], m // 4)
    dup = rng.integers(0, m, size=m // 3)
    hi[m - m // 3 :], lo[m - m // 3 :] = hi[dup], lo[dup]
    hi[:5], lo[:5] = jdedup.SENT, jdedup.SENT  # sentinel (invalid) rows
    return hi, lo


def test_sort_pairs_matches_lexsort():
    hi, lo = pairs(2048, seed=1)
    want = np.asarray(jnp.lexsort((jnp.asarray(lo), jnp.asarray(hi))))
    got = dedup.sort_pairs(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_occurrence_matches_jax():
    hi, lo = pairs(2048, seed=2)
    order = np.lexsort((lo, hi))
    hi_s, lo_s = hi[order], lo[order]
    inv = (hi_s == jdedup.SENT) & (lo_s == jdedup.SENT)
    want = jdedup.first_occurrence_mask(jnp.asarray(hi_s), jnp.asarray(lo_s), jnp.asarray(inv))
    got = dedup.first_occurrence_mask(
        torch.from_numpy(hi_s.astype(np.int64)),
        torch.from_numpy(lo_s.astype(np.int64)),
        torch.from_numpy(inv),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pair_key_round_trip_and_sentinel():
    hi, lo = pairs(512, seed=3)
    th = torch.from_numpy(hi.astype(np.int64))
    tl = torch.from_numpy(lo.astype(np.int64))
    key = dedup.pair_key(th, tl)
    np.testing.assert_array_equal(
        key.numpy().view(np.uint64),
        (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64),
    )
    h2, l2 = dedup.split_key(key)
    assert torch.equal(h2, th) and torch.equal(l2, tl)
    assert int(dedup.pair_key(torch.tensor([dedup.SENT]), torch.tensor([dedup.SENT]))) == dedup.SENT_KEY


def sorted_set(rng, cap, set_n):
    """JAX's (set_hi, set_lo) uint32[cap], the first set_n ascending and
    distinct: hi from a small pool (equal hi, other lo), half of it >= 2^31,
    so the unsigned order differs from the signed one; the rest padding."""
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF], np.uint32)
    pairs = set()
    while len(pairs) < set_n:
        pairs.add((int(rng.choice(pool)), int(rng.integers(0, 2**32 - 1, dtype=np.uint64))))
    pairs = sorted(pairs)
    hi = np.full(cap, jdedup.SENT, np.uint32)
    lo = np.full(cap, jdedup.SENT, np.uint32)
    hi[:set_n] = [p[0] for p in pairs]
    lo[:set_n] = [p[1] for p in pairs]
    return hi, lo


def port_keys(hi, lo):
    return dedup.order_key(torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)))


def queries(rng, hi, lo, set_n, m):
    """Members, non-members beside them (same hi, lo one off), random pairs
    and sentinel (invalid) pairs."""
    q_hi = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    q_lo = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    if set_n:
        pick = rng.integers(0, set_n, size=m // 2)
        q_hi[: m // 2], q_lo[: m // 2] = hi[pick], lo[pick]
        q_lo[m // 4 : m // 2] += np.uint32(1)
    q_hi[-3:], q_lo[-3:] = jdedup.SENT, jdedup.SENT
    return q_hi, q_lo


@pytest.mark.parametrize("set_n", [0, 1, 63, 64])
def test_rank_and_member_sorted_match_jax(set_n):
    rng = np.random.default_rng(set_n)
    cap = 64
    hi, lo = sorted_set(rng, cap, set_n)
    q_hi, q_lo = queries(rng, hi, lo, set_n, 200)
    j_found, j_rank = jdedup.rank_sorted(*map(jnp.asarray, (hi, lo)), set_n,
                                         jnp.asarray(q_hi), jnp.asarray(q_lo))
    t_found, t_rank = dedup.rank_sorted(port_keys(hi, lo), set_n, port_keys(q_hi, q_lo))
    np.testing.assert_array_equal(t_found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    j_member = jdedup.member_sorted(*map(jnp.asarray, (hi, lo)), set_n,
                                    jnp.asarray(q_hi), jnp.asarray(q_lo))
    t_member = dedup.member_sorted(port_keys(hi, lo), set_n, port_keys(q_hi, q_lo))
    np.testing.assert_array_equal(t_member.numpy(), np.asarray(j_member))


@pytest.mark.parametrize("set_n, new_n, out_cap", [
    (0, 0, 64), (0, 20, 64), (1, 0, 64), (1, 30, 64), (40, 24, 64), (63, 1, 64),
    (64, 0, 64), (64, 40, 128), (40, 20, 256),
])
def test_merge_ranked_matches_jax(set_n, new_n, out_cap):
    """The merged set equals JAX's, entry for entry, padding included: new
    keys among, before and after the set's, out_cap above the set's
    capacity as grow_visited leaves it."""
    rng = np.random.default_rng(100 + set_n + new_n)
    cap = 64
    hi, lo = sorted_set(rng, set_n + new_n, set_n + new_n)
    take = np.sort(rng.choice(set_n + new_n, size=new_n, replace=False))
    is_new = np.zeros(set_n + new_n, bool)
    is_new[take] = True
    s_hi = np.full(cap, jdedup.SENT, np.uint32)
    s_lo = np.full(cap, jdedup.SENT, np.uint32)
    s_hi[:set_n], s_lo[:set_n] = hi[~is_new], lo[~is_new]
    m = new_n + 5  # a padded batch, as the JAX step hands it
    n_hi = np.full(m, jdedup.SENT, np.uint32)
    n_lo = np.full(m, jdedup.SENT, np.uint32)
    n_hi[:new_n], n_lo[:new_n] = hi[is_new], lo[is_new]
    s_hi_j, s_lo_j = jnp.asarray(s_hi), jnp.asarray(s_lo)
    _, j_rank = jdedup.rank_sorted(s_hi_j, s_lo_j, set_n, jnp.asarray(n_hi), jnp.asarray(n_lo))
    j_hi, j_lo, j_n = jdedup.merge_ranked(s_hi_j, s_lo_j, set_n, jnp.asarray(n_hi),
                                          jnp.asarray(n_lo), j_rank, new_n, out_cap)

    keys = port_keys(s_hi, s_lo)
    new = port_keys(n_hi[:new_n], n_lo[:new_n])
    _, rank = dedup.rank_sorted(keys, set_n, new)
    merged, n = dedup.merge_ranked(keys, set_n, new, rank, out_cap)
    assert n == int(j_n) == set_n + new_n
    t_hi, t_lo = dedup.order_key_to_pair(merged)
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))


def test_merge_ranked_refuses_to_drop_keys():
    """Where JAX drops what does not fit, the port raises."""
    keys = torch.full((4,), dedup.PAD)
    keys[:3] = torch.tensor([1, 2, 3])
    new = torch.tensor([5, 6])
    with pytest.raises(ValueError, match="do not fit"):
        dedup.merge_ranked(keys, 3, new, dedup.rank_sorted(keys, 3, new)[1], 4)
