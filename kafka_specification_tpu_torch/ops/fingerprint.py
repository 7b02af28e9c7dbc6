"""64-bit state fingerprints as (hi, lo) pairs of u32 values (PyTorch).

Counterpart of ``kafka_specification_tpu/ops/fingerprint.py``, bit for bit.
Two modes:

- exact: when the packed state fits in <= 64 bits, the fingerprint IS the
  state (lane 0 -> lo, lane 1 -> hi), so dedup is collision-free;
- hashed: murmur3_x86_32 over the lanes with two seeds.  Collision risk for
  n states is ~n^2/2^65, the regime TLC accepts.

Every value is a u32 held in ``torch.int64``.  The 32-bit products are
formed from 16-bit halves so no intermediate leaves the signed 64-bit range
(torch on the CPU has no unsigned 32-bit arithmetic).  These are the plain
versions of kernel K1 (``ops/cuda_fingerprint.py``), which also runs them on
a CUDA tensor to check the kernel.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
SEED_HI = 0x9747B28C
SEED_LO = 0x3C6EF372


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values x and a u32 constant c."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full 32-bit avalanche."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _murmur3_lanes(lanes: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3_x86_32 over the trailing lane axis of int64[..., K]."""
    k = lanes.shape[-1]
    h = torch.full(lanes.shape[:-1], seed, dtype=torch.int64, device=lanes.device)
    for i in range(k):
        kx = mul32(lanes[..., i], _C1)
        kx = mul32(_rotl32(kx, 15), _C2)
        h = h ^ kx
        h = (mul32(_rotl32(h, 13), 5) + 0xE6546B64) & MASK32
    return fmix32(h ^ (4 * k))


def hash_pair(lanes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hashed-mode fingerprint pair.  The all-ones pair is the dedup padding
    sentinel, so a state hashing to it is remapped to lo = 0xFFFFFFFE."""
    hi = _murmur3_lanes(lanes, SEED_HI)
    lo = _murmur3_lanes(lanes, SEED_LO)
    is_sent = (hi == MASK32) & (lo == MASK32)
    lo = torch.where(is_sent, 0xFFFFFFFE, lo)
    return hi, lo


def fingerprint_lanes(
    lanes: torch.Tensor, exact: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """int64[..., K] packed states -> (hi, lo) int64 fingerprints."""
    if exact:
        lo = lanes[..., 0]
        hi = lanes[..., 1] if lanes.shape[-1] > 1 else torch.zeros_like(lo)
        return hi, lo
    return hash_pair(lanes)
