"""Batch dedup over (hi, lo) fingerprint pairs (PyTorch).

Counterpart of the part of ``kafka_specification_tpu/ops/dedup.py`` that
the device-hash backend uses: the sentinel, the stable sort on the
UNSIGNED pair and first-occurrence marking.  The pair rides as one 64-bit
key: ``key = hi << 32 | lo`` as an int64 bit pattern.  A signed sort of that
key would put every hi >= 2^31 first, so the sort flips the top bit, which
maps unsigned order onto signed order.  The stable sort keeps equal pairs in
candidate order, as ``jnp.lexsort((lo, hi))`` does, so the first copy of a
state is the one that carries its parent and action into the trace.
"""

from __future__ import annotations

import torch

# all-ones u32: the empty-slot / padding sentinel of both lanes
SENT = 0xFFFFFFFF
# the all-ones pair as a packed key
SENT_KEY = -1
_TOP_BIT = -(1 << 63)


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 values -> the int64 bit pattern of hi << 32 | lo."""
    hi_signed = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return hi_signed * (1 << 32) + lo


def split_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pair_key: int64 keys -> (hi, lo) u32 values."""
    return (key >> 32) & SENT, key & SENT


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of the unsigned (hi, lo) pairs: the
    permutation ``jnp.lexsort((lo, hi))`` gives."""
    return torch.sort(pair_key(hi, lo) ^ _TOP_BIT, stable=True).indices


def first_occurrence_mask(hi_s, lo_s, invalid_s):
    """After sorting: True for the first copy of each distinct valid pair."""
    prev_same = torch.zeros_like(invalid_s)
    prev_same[1:] = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    return ~invalid_s & ~prev_same
