"""Kernel K2: insert-or-find into the open-addressing fingerprint table.

Replaces both TPU entry points of ``kafka_specification_tpu/ops/
pallas_hashset.py``: ``probe_insert_pallas`` (table staged in VMEM, so
capped at 2^20 slots) and ``probe_insert_pallas_hbm`` (table left in HBM).
On the card the table always lives in device memory, so one kernel serves
both and has no capacity gate.  The CUDA source is ``csrc/hashset.cu``; its
header gives the design (find, insert and claim, winner, in one cooperative
launch; epoch-tagged claim words) and what bounds it.

``probe_insert(table, q, valid=None)`` is the entry point, with the contract
of ``hashset.probe_insert`` except that ``n_new`` and ``overflow`` come back
as a host int and bool, read together; ``valid=None`` means every row.  On
a CPU tensor it runs that plain version; on a CUDA tensor it launches the
kernel or raises.  Winners, ``n_new`` and table membership equal the plain
version's; slot positions may differ where two probe chains interleave,
which changes neither.  ``LAUNCHES`` counts calls that launched the kernel.
A launch goes through ``build``'s launch route, on the table's card.

A call on the card runs no PyTorch operation there and allocates only its
outputs.  The workspace is kept per (device, stream): one claim array as
long as the largest table seen there, filled once when it is made and
never reset (each call tags its claims with a code one below the last
call's), and a row scratch as long as the largest batch seen.  A larger
table replaces the claim array, so the workspace holds 8 bytes a slot of
the largest table and 4 bytes a row of the largest batch, for the life of
the process.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .hashset import MAX_PROBES
from .hashset import probe_insert as probe_insert_plain

LAUNCHES = 0
MAX_CAP = 1 << 31  # slots are int32 in the row scratch
MAX_ROWS = (1 << 32) - 2  # a row is the low half of a claim word; all ones is the fill
FIRST_CODE = (1 << 32) - 1
_p, _ll = ctypes.c_void_p, ctypes.c_longlong
# table, claim, cap, q, valid, m, max_probes, code, slot, is_new, counts, device, stream
KSPEC_PROBE_INSERT = build.Entry(
    "hashset", "kspec_probe_insert",
    (_p, _p, _ll, _p, _p, _ll, ctypes.c_int, ctypes.c_uint, _p, _p, _p, ctypes.c_int, _p))

# (device index, stream) -> [claim words int64[>= cap], this call's code]
_CLAIMS: dict[tuple[int, int], list] = {}
# (device index, stream) -> int32 row scratch, as long as the largest batch seen
_SLOTS: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(dev, stream: int, cap: int, m: int):
    """(claim words, code, row scratch) for one call; advances the code."""
    key = (dev.index, stream)
    ws = _CLAIMS.get(key)
    if ws is None or ws[0].shape[0] < cap or ws[1] < 0:  # 2^32 calls: fill again
        _CLAIMS.pop(key, None)  # let the allocator reuse the old words
        ws = _CLAIMS[key] = [torch.full((cap,), -1, dtype=torch.int64, device=dev), FIRST_CODE]
    claim, code = ws
    ws[1] = code - 1
    slot = _SLOTS.get(key)
    if slot is None or slot.shape[0] < m:
        slot = _SLOTS[key] = torch.empty(
            1 << max(0, m - 1).bit_length(), dtype=torch.int32, device=dev)
    return claim, code, slot


def _check(table: torch.Tensor, q: torch.Tensor, valid) -> int:
    """-> the card index of a call the kernel takes; raises otherwise."""
    if not table.is_cuda:
        raise ValueError(f"kernel K2 needs CUDA tensors, got {table.device}")
    cap = table.shape[0]
    if table.dtype is not torch.int64 or table.dim() != 1 or cap & (cap - 1):
        raise ValueError("table must be int64[cap] with cap a power of two")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (it is updated in place)")
    if cap > MAX_CAP:
        raise ValueError(f"table capacity {cap} exceeds the kernel's {MAX_CAP} slots")
    index = table.get_device()
    if (q.dtype is not torch.int64 or q.dim() != 1 or q.get_device() != index
            or not q.is_contiguous()):
        raise ValueError("keys must be contiguous int64[M] on the table's device")
    m = q.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"{m} keys: a claim word holds row indices below {MAX_ROWS + 1}")
    if valid is not None and (valid.dtype is not torch.bool or valid.shape != q.shape
                              or valid.get_device() != index or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool[M] beside the keys, or None")
    return index


def launch(table: torch.Tensor, q: torch.Tensor, valid=None):
    """The kernel itself: int64[cap] table (updated in place) x int64[M]
    keys x bool[M] (None: every row valid) on the card -> (is_new bool[M],
    counts int32[2]: n_new, overflow)."""
    global LAUNCHES
    index = _check(table, q, valid)
    cap, m = table.shape[0], q.shape[0]
    stream = build.stream_handle(index)
    # the one torch.device of a call: the workspace is made on it and keyed by its index
    claim, code, slot = _workspace(table.device, stream, cap, m)
    is_new = q.new_empty(m, dtype=torch.bool)
    counts = q.new_empty(2, dtype=torch.int32)
    rc = KSPEC_PROBE_INSERT.call(
        table.data_ptr(), claim.data_ptr(), cap, q.data_ptr(),
        None if valid is None else valid.data_ptr(), m, MAX_PROBES, code,
        slot.data_ptr(), is_new.data_ptr(), counts.data_ptr(), index, stream,
    )
    if rc:
        raise KSPEC_PROBE_INSERT.error(rc, "hash probe kernel launch")
    LAUNCHES += 1
    return is_new, counts


def probe_insert(table, q, valid=None):
    """Insert-or-find (see hashset.probe_insert): -> (table, is_new bool[M],
    n_new int, overflow bool); the table is updated in place, and n_new and
    overflow are read to the host in one read."""
    if table.is_cpu:
        table, is_new, n_new, overflow = probe_insert_plain(table, q, valid)
        return table, is_new, int(n_new), bool(overflow)
    is_new, counts = launch(table, q, valid)
    n_new, overflow = counts.tolist()
    return table, is_new, n_new, bool(overflow)

