"""PyTorch port: the unsigned pair sort and first-occurrence marking equal
the JAX package's jnp.lexsort((lo, hi)) and dedup.first_occurrence_mask."""

import numpy as np

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
