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
TOP_BIT = -(1 << 63)
# the sentinel pair as an order key: the sorted set's padding
PAD = SENT_KEY ^ TOP_BIT


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
    return pair_key(hi, lo) ^ TOP_BIT


def order_key_to_pair(okey: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of order_key."""
    return split_key(okey ^ TOP_BIT)


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


# --------------------------------------------------------------------------
# fixed-capacity variants for the device-resident level pipeline: no
# Python count, no slice by it, no raise; the count is a tensor and
# entries that do not land go to a dump slot
# --------------------------------------------------------------------------


def rank_full(set_keys: torch.Tensor, q: torch.Tensor):
    """rank_sorted over a whole fixed-capacity set, ascending keys then its
    PAD tail -> (found bool, rank int64).  A valid query (below PAD) never
    matches the tail, so the set's count is not needed."""
    cap = set_keys.shape[0]
    rank = torch.searchsorted(set_keys, q, side="left")
    found = set_keys.gather(0, rank.clamp(max=cap - 1)) == q
    return found & (q != PAD), rank


def merge_full(set_keys: torch.Tensor, set_n: torch.Tensor, new_keys: torch.Tensor,
               new_rank: torch.Tensor, new_n: torch.Tensor) -> torch.Tensor:
    """merge_ranked at a fixed capacity with tensor counts: `new_keys`
    holds `new_n` keys, ascending, disjoint from the set, each with its
    rank in the set (rank_full), then PAD.  The same two scatters:

        target(new[j]) = rank[j] + j                        (j < new_n)
        target(set[i]) = i + (# new keys below set[i])      (i < set_n)

    into a buffer one longer than the set, whose last slot takes every
    entry past the counts.  The caller keeps set_n + new_n <= capacity.
    -> the merged keys, int64[capacity]."""
    cap = set_keys.shape[0]
    dev = set_keys.device
    out = torch.full((cap + 1,), PAD, dtype=torch.int64, device=dev)
    i = torch.arange(cap, device=dev)
    below = torch.searchsorted(new_keys, set_keys, side="left")
    out.index_copy_(0, torch.where(i < set_n, i + below, cap).clamp(max=cap), set_keys)
    j = torch.arange(new_keys.shape[0], device=dev)
    out.index_copy_(0, torch.where(j < new_n, new_rank + j, cap).clamp(max=cap), new_keys)
    return out[:cap]
