"""Batch dedup and the sorted visited set over (hi, lo) fingerprint pairs
(PyTorch).

Counterpart of ``kafka_specification_tpu/ops/dedup.py``: the sentinel, the
stable sort on the UNSIGNED pair, first-occurrence marking, and the sorted
pair set of the ``device`` visited backend (``rank_sorted``,
``member_sorted``, ``merge_ranked``).

The pair rides as one 64-bit key: ``key = hi << 32 | lo`` as an int64 bit
pattern (``pair_key``).  A signed sort of that key would put every
hi >= 2^31 first, so sorting uses the ORDER KEY ``key ^ (1 << 63)``
(``order_key``), which maps unsigned pair order onto signed int64 order.
The stable sort keeps equal pairs in candidate order, as
``jnp.lexsort((lo, hi))`` does, so the first copy of a state is the one
that carries its parent and action into the trace.

The sorted visited set is ONE int64 array of order keys, ascending over its
first ``set_n`` entries and padded with ``PAD``, the order key of the
all-ones sentinel pair (int64 max), where the JAX package keeps two uint32
arrays.  No fingerprint is the sentinel pair (``fingerprint.hash_pair``
remaps it), so the padding sorts after every valid entry.
"""

from __future__ import annotations

import torch

# all-ones u32: the empty-slot / padding sentinel of both lanes
SENT = 0xFFFFFFFF
# the all-ones pair as a packed key
SENT_KEY = -1
_TOP_BIT = -(1 << 63)
# the sentinel pair as an order key: the sorted set's padding
PAD = SENT_KEY ^ _TOP_BIT


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 values -> the int64 bit pattern of hi << 32 | lo."""
    hi_signed = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return hi_signed * (1 << 32) + lo


def split_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pair_key: int64 keys -> (hi, lo) u32 values."""
    return (key >> 32) & SENT, key & SENT


def order_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 values -> int64 keys whose signed order is the unsigned
    order of the pairs."""
    return pair_key(hi, lo) ^ _TOP_BIT


def order_key_to_pair(okey: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of order_key."""
    return split_key(okey ^ _TOP_BIT)


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of the unsigned (hi, lo) pairs: the
    permutation ``jnp.lexsort((lo, hi))`` gives."""
    return torch.sort(order_key(hi, lo), stable=True).indices


def first_occurrence_mask(hi_s, lo_s, invalid_s):
    """After sorting: True for the first copy of each distinct valid pair."""
    prev_same = torch.zeros_like(invalid_s)
    prev_same[1:] = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    return ~invalid_s & ~prev_same


def rank_sorted(set_keys: torch.Tensor, set_n: int, q: torch.Tensor):
    """Lower-bound rank of order keys `q` among the first `set_n` entries of
    the sorted set -> (found bool, rank int64), rank = bisect_left."""
    valid = set_keys[:set_n]
    rank = torch.searchsorted(valid, q, side="left")
    if set_n == 0:
        return torch.zeros_like(q, dtype=torch.bool), rank
    found = (rank < set_n) & (valid[rank.clamp(max=set_n - 1)] == q)
    return found, rank


def member_sorted(set_keys: torch.Tensor, set_n: int, q: torch.Tensor) -> torch.Tensor:
    """Membership probe (see rank_sorted)."""
    return rank_sorted(set_keys, set_n, q)[0]


def merge_ranked(set_keys, set_n: int, new_keys, new_rank, out_cap: int):
    """Scatter-merge of the sorted set and `new_keys`, sorted ascending and
    disjoint from the set, each with its insertion rank in the set (from
    rank_sorted).  Two scatters and no re-sort, as the JAX package does:

        target(new[j]) = rank[j] + j
        target(set[i]) = i + (# new keys below set[i])

    Only the valid entries are written (torch raises on the out-of-range
    targets that JAX drops).  -> (keys int64[out_cap], set_n + new_n)."""
    new_n = new_keys.shape[0]
    if set_n + new_n > out_cap:
        raise ValueError(f"{set_n} + {new_n} keys do not fit a set of capacity {out_cap}")
    old = set_keys[:set_n]
    out = torch.full((out_cap,), PAD, dtype=torch.int64, device=set_keys.device)
    below = torch.searchsorted(new_keys, old, side="left")
    out[torch.arange(set_n, device=out.device) + below] = old
    out[new_rank + torch.arange(new_n, device=out.device)] = new_keys
    return out, set_n + new_n
