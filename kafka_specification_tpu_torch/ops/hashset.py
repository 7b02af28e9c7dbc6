"""Open-addressing fingerprint set in device memory (PyTorch).

Counterpart of ``kafka_specification_tpu/ops/hashset.py``: a power-of-two
table probed with linear probing from the home slot
``fmix32(lo ^ fmix32(hi)) & (cap - 1)`` for at most ``MAX_PROBES`` slots,
with the same insert-or-find contract: after ``probe_insert``, ``is_new`` is
True for exactly the lowest-index valid row of each fingerprint not already
in the table, and ``overflow`` says some row ran out of probes (the caller
grows the table and re-runs the batch; nothing is dropped silently).

One slot is one int64 holding the key ``hi << 32 | lo`` (``dedup.pair_key``);
the all-ones key marks an empty slot.  One word per slot is what lets the
CUDA kernel claim a slot with a single 64-bit compare-and-swap.

``probe_insert`` here is the plain version of kernel K2
(``ops/cuda_hashset.py``): the claim-lattice algorithm of the JAX module,
round by round.  It updates the table in place.  ``table_from_pairs`` and
``rehash_into`` insert through K2's wrapper with no mask, so on a CUDA table
they launch the kernel.
"""

from __future__ import annotations

import torch

from .dedup import SENT_KEY, pair_key, split_key
from .fingerprint import fmix32

CLAIM_FREE = 0x7FFFFFFF  # int32 max: "this slot was never claimed"
# probe budget per row; with the load kept under 1/2 the expected probe
# count is ~1.5, and an exhausted budget is reported, never dropped
MAX_PROBES = 32
_INSERT_CHUNK = 1 << 20  # rows per insert call when (re)building a table


def new_table(cap: int, device) -> torch.Tensor:
    """Empty table of `cap` slots (cap must be a power of two)."""
    if cap <= 0 or cap & (cap - 1):
        raise ValueError(f"hash table capacity must be a power of 2, got {cap}")
    return torch.full((cap,), SENT_KEY, dtype=torch.int64, device=device)


def home_slot(q: torch.Tensor, cap: int) -> torch.Tensor:
    """Home slot of each key: full avalanche of both halves, so exact-mode
    keys (raw packed states, low entropy in the low bits) spread uniformly."""
    hi, lo = split_key(q)
    return fmix32(lo ^ fmix32(hi)) & (cap - 1)


def probe_insert(table, q, valid=None):
    """Insert-or-find a batch of keys (plain version; updates `table`).

    table: int64[cap]; q: int64[M] keys; valid: bool[M] masks live rows
    (None: every row).
    Returns (table, is_new bool[M], n_new int64 scalar, overflow bool scalar).

    Per probe round, every still-pending row reads its slot: on a match it
    is seen and done; on an empty slot it claims the slot by a scatter-min
    of its row index, and the winner writes its key and is new, while the
    losers re-read the slot next round (an in-batch duplicate then matches);
    on a foreign key it moves to the next slot.  The claim array starts
    fresh each call; a stale claim could only sit on a slot that was filled
    when it was claimed, and a filled slot is never claimed again.
    """
    cap = table.shape[0]
    m = q.shape[0]
    rows = torch.arange(m, device=q.device)
    claim = torch.full((cap,), CLAIM_FREE, dtype=torch.int64, device=q.device)
    pos = home_slot(q, cap)
    pending = torch.ones(m, dtype=torch.bool, device=q.device) if valid is None else valid.clone()
    is_new = torch.zeros(m, dtype=torch.bool, device=q.device)
    for _ in range(MAX_PROBES):
        cur = table[pos]
        match = pending & (cur == q)
        empty = pending & (cur == SENT_KEY)
        claim.scatter_reduce_(0, pos[empty], rows[empty], reduce="amin")
        won = empty & (claim[pos] == rows)
        table[pos[won]] = q[won]
        advance = pending & ~match & ~won & ~empty
        pos = torch.where(advance, (pos + 1) & (cap - 1), pos)
        pending = pending & ~match & ~won
        is_new |= won
    return table, is_new, is_new.sum(), pending.any()


def table_from_pairs(hi, lo, min_cap: int = 1 << 10):
    """Table holding exactly the given (assumed distinct) pairs, on their
    device.  Capacity is max(min_cap, 4 * len) rounded up to a power of two;
    a probe overflow (improbable at 1/4 load) doubles it and starts over."""
    from .cuda_hashset import probe_insert as insert

    n = int(hi.shape[0])
    cap = max(int(min_cap), 4 * n, 2)
    cap = 1 << (cap - 1).bit_length()
    keys = pair_key(hi, lo)
    while True:
        table = new_table(cap, hi.device)
        ok = True
        for start in range(0, n, _INSERT_CHUNK):
            table, _new, _n, ovf = insert(table, keys[start : start + _INSERT_CHUNK])
            if ovf:
                ok = False
                break
        if ok:
            return table
        cap *= 2


def live_pairs(table: torch.Tensor):
    """(hi, lo) of every occupied slot, in slot order."""
    return split_key(table[table != SENT_KEY])


def rehash_into(table: torch.Tensor, new_cap: int):
    """Grow: a table of capacity >= `new_cap` holding every live key."""
    hi, lo = live_pairs(table)
    return table_from_pairs(hi, lo, min_cap=new_cap)
