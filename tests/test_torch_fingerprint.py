"""PyTorch port: fingerprints and the plain version of kernel K1 equal the
JAX package's jnp path and its Pallas kernel (interpret mode), exactly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kafka_specification_tpu.ops import dedup as jdedup
from kafka_specification_tpu.ops.fingerprint import fingerprint_lanes as j_fp
from kafka_specification_tpu.ops.pallas_fingerprint import fingerprint_pallas
from kafka_specification_tpu_torch.ops import cuda_fingerprint
from kafka_specification_tpu_torch.ops.fingerprint import fingerprint_lanes, mul32


def u32(t):
    return t.numpy().astype(np.uint32)


def make_rows(m, k, seed):
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 2**32, size=(m, k), dtype=np.uint32)
    lanes[:8] = 0xFFFFFFFF  # top-of-range lanes
    valid = rng.random(m) >= 0.1
    return lanes, valid


@pytest.mark.parametrize("k", [1, 3, 7])
def test_plain_k1_matches_jnp_and_pallas(k):
    lanes, valid = make_rows(1024, k, seed=k)
    sent = np.uint32(jdedup.SENT)
    hi_ref, lo_ref = j_fp(jnp.asarray(lanes), exact=False)
    hi_ref = np.where(valid, np.asarray(hi_ref), sent)
    lo_ref = np.where(valid, np.asarray(lo_ref), sent)
    p_hi, p_lo = fingerprint_pallas(
        jnp.asarray(lanes), jnp.asarray(valid), block_rows=256, interpret=True
    )

    t_lanes = torch.from_numpy(lanes.astype(np.int64))
    t_valid = torch.from_numpy(valid)
    hi, lo = cuda_fingerprint.fingerprint_plain(t_lanes, t_valid)
    np.testing.assert_array_equal(u32(hi), hi_ref)
    np.testing.assert_array_equal(u32(lo), lo_ref)
    np.testing.assert_array_equal(u32(hi), np.asarray(p_hi))
    np.testing.assert_array_equal(u32(lo), np.asarray(p_lo))
    # the wrapper takes the plain version for a CPU tensor
    w_hi, w_lo = cuda_fingerprint.fingerprint(t_lanes, t_valid)
    assert torch.equal(w_hi, hi) and torch.equal(w_lo, lo)


@pytest.mark.parametrize("k", [1, 2])
def test_exact_mode_matches_jax(k):
    lanes, _ = make_rows(256, k, seed=10 + k)
    want_hi, want_lo = j_fp(jnp.asarray(lanes), exact=True)
    hi, lo = fingerprint_lanes(torch.from_numpy(lanes.astype(np.int64)), exact=True)
    np.testing.assert_array_equal(u32(hi), np.asarray(want_hi))
    np.testing.assert_array_equal(u32(lo), np.asarray(want_lo))


def test_all_ones_pair_is_remapped_like_jax(monkeypatch):
    """A valid state hashing to the all-ones sentinel pair is remapped to
    lo = 0xFFFFFFFE in both packages (no preimage is known, so both hash
    functions are forced to all ones)."""
    from kafka_specification_tpu.ops import fingerprint as jfp
    from kafka_specification_tpu_torch.ops import fingerprint as tfp

    monkeypatch.setattr(
        jfp, "_murmur3_lanes", lambda x, seed: jnp.full(x.shape[:-1], 0xFFFFFFFF, jnp.uint32)
    )
    monkeypatch.setattr(
        tfp, "_murmur3_lanes", lambda x, seed: torch.full(x.shape[:-1], 0xFFFFFFFF)
    )
    want = jfp.hash_pair(jnp.zeros((4, 3), jnp.uint32))
    got = tfp.hash_pair(torch.zeros((4, 3), dtype=torch.int64))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(u32(g), np.asarray(w))
    assert int(got[1][0]) == 0xFFFFFFFE


def test_mul32_is_u32_multiplication():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    for c in (0xCC9E2D51, 0x1B873593, 0x85EBCA6B, 0xC2B2AE35, 5):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_i32_carrier_round_trip():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1])
    x32 = cuda_fingerprint.to_i32(x)
    assert x32.dtype == torch.int32
    np.testing.assert_array_equal(x32.numpy().view(np.uint32), x.numpy().astype(np.uint32))
    assert torch.equal(cuda_fingerprint.from_i32(x32), x)


def test_kernel_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fingerprint.launch(
            torch.zeros((4, 3), dtype=torch.int64), torch.ones(4, dtype=torch.bool)
        )
