"""Device-resident level helpers: the fingerprint-multiset digest folded on
the card, the level-new capacity policy, and the dump-slot appends that
assemble a level's outputs (PyTorch).

Counterpart of ``kafka_specification_tpu/ops/devlevel.py``.  The device
level pipeline (``engine/pipeline.py::DevicePipeline``) queues every chunk
of a level on the card with no host read between them, so the per-chunk
host work of the fused path (digest folds, frontier assembly) becomes
tensor operations here:

- ``masked_digest`` / ``combine_digest`` / ``digest_ints``: the (count,
  xor, wrapping sum mod 2^64) digest of a set of u64 fingerprints, kept
  as one int64[3] tensor.  torch's int64 add wraps in two's complement, so
  the sum needs none of the JAX package's 16-bit limbs; ``digest_ints``
  gives the exact ints ``resilience/integrity.py::digest_fps`` gives for
  the same multiset, which ``LevelDigestChain.fold_digest`` folds.
- ``level_new_capacity`` / ``level_new_bound``: the size of the level-new
  sorted set (the JAX package's ladder, ``LN_HEADROOM``,
  ``LN_SAFE_SMALL``).
- ``append_slots`` / ``append_rows`` / ``append_vec``: write a chunk's
  selected entries at the level's running offset.  Where JAX writes a
  whole segment with ``dynamic_update_slice`` (and must size its buffers
  one chunk past the level, since the start index clamps), these scatter
  only the selected entries and send the others to the buffer's last row,
  the dump slot: an index past a CUDA buffer would raise a device-side
  assert, which kills the context.
"""

from __future__ import annotations

import torch

# headroom over the measured per-level new-state high water
LN_HEADROOM = 1.35
# below this many entries the level-new set takes the safe bound outright
LN_SAFE_SMALL = 1 << 16
_M64 = (1 << 64) - 1


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def level_new_capacity(T: int, ln_hw: int, worst: int) -> int:
    """The level-new set's capacity: the measured per-level new-state high
    water `ln_hw` with headroom, floored at one chunk's width `T` and capped
    at the safe bound `worst` (chunks x width); small levels take the safe
    bound outright."""
    safe = next_pow2(worst)
    if safe <= LN_SAFE_SMALL:
        return safe
    return min(next_pow2(max(T, int(LN_HEADROOM * ln_hw) + 1)), safe)


def level_new_bound(worst: int) -> int:
    """The safe (cannot overflow) level-new capacity of a re-dispatch."""
    return next_pow2(worst)


def zero_digest(device) -> torch.Tensor:
    """The neutral accumulator: int64[3] (count, xor, sum)."""
    return torch.zeros(3, dtype=torch.int64, device=device)


# kspec: traced
def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of all elements of an int64 vector, as a 0-d tensor (a halving
    tree: torch has no XOR reduction)."""
    n = next_pow2(x.shape[0])
    if n != x.shape[0]:
        x = torch.cat([x, x.new_zeros(n - x.shape[0])])
    while n > 1:
        n //= 2
        x = x[:n] ^ x[n:]
    return x[0]


# kspec: traced
def masked_digest(fps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(count, xor, sum) over the u64 fingerprints (int64 bit patterns)
    selected by `valid`, as int64[3]."""
    m = torch.where(valid, fps, 0)
    return torch.stack([valid.sum(), xor_reduce(m), m.sum()])


# kspec: traced
def combine_digest(acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Fold one chunk's digest into the running level accumulator."""
    return torch.stack([acc[0] + new[0], acc[1] ^ new[1], acc[2] + new[2]])


def digest_ints(acc) -> tuple:
    """Accumulator (tensor or 3 ints) -> (count, xor, sum) Python ints,
    equal to ``integrity.digest_fps`` over the same multiset."""
    count, xor, total = (int(v) for v in (acc.tolist() if torch.is_tensor(acc) else acc))
    return count, xor & _M64, total & _M64


# kspec: traced
def append_slots(pos: torch.Tensor, take: torch.Tensor, offset: torch.Tensor,
                 dump: int) -> torch.Tensor:
    """The output row of each of a chunk's entries: `offset + pos` for an
    entry it keeps (`take`), else the dump row.  The caller keeps
    ``offset + pos`` below the dump row."""
    return torch.where(take, offset + pos, dump)


# kspec: traced
def append_rows(buf: torch.Tensor, seg: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Write `seg`'s rows at their slots of `buf` (``append_slots``)."""
    return buf.index_copy_(0, slots, seg)


append_vec = append_rows  # index_copy_ writes vectors and rows alike
