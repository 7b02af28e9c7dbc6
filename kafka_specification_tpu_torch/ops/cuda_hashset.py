"""Kernel K2: insert-or-find into the open-addressing fingerprint table.

Replaces both TPU entry points of ``kafka_specification_tpu/ops/
pallas_hashset.py``: ``probe_insert_pallas`` (table staged in VMEM, so
capped at 2^20 slots) and ``probe_insert_pallas_hbm`` (table left in HBM).
On the card the table always lives in device memory, so one kernel serves
both and has no capacity gate.  The CUDA source is ``csrc/hashset.cu``; its
header gives the design (find, CAS insert, claim, winner) and what bounds it.

``probe_insert(table, q, valid)`` is the entry point, with the contract of
``hashset.probe_insert``.  On a CPU tensor it runs that plain version; on a
CUDA tensor it launches the kernel or raises.  Winners, ``n_new`` and table
membership equal the plain version's; slot positions may differ where two
probe chains interleave, which changes neither.  ``LAUNCHES`` counts calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .hashset import MAX_PROBES
from .hashset import probe_insert as probe_insert_plain

LAUNCHES = 0


def launch(table: torch.Tensor, q: torch.Tensor, valid8: torch.Tensor):
    """The kernel itself: int64[cap] table (updated in place) x int64[M]
    keys x uint8[M] on the card -> (is_new uint8[M], n_new int32[1],
    overflow int32[1])."""
    global LAUNCHES
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"kernel K2 needs CUDA tensors, got {dev}")
    cap = table.shape[0]
    if table.dtype != torch.int64 or table.dim() != 1 or cap & (cap - 1):
        raise ValueError("table must be int64[cap] with cap a power of two")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous (it is updated in place)")
    if cap > 1 << 31:
        raise ValueError(f"table capacity {cap} exceeds the kernel's int32 slots")
    if q.dtype != torch.int64 or q.dim() != 1 or q.device != dev:
        raise ValueError("keys must be int64[M] on the table's device")
    if valid8.dtype != torch.uint8 or valid8.shape != q.shape or valid8.device != dev:
        raise ValueError("valid must be uint8[M] beside the keys")
    q = q.contiguous()
    valid8 = valid8.contiguous()
    m = q.shape[0]
    is_new = torch.zeros(m, dtype=torch.uint8, device=dev)
    n_new = torch.zeros(1, dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    if m == 0:
        return is_new, n_new, overflow
    claim = torch.empty(cap, dtype=torch.int32, device=dev)
    slot = torch.empty(m, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.kspec_probe_insert(
        table.data_ptr(), claim.data_ptr(), cap, q.data_ptr(),
        valid8.data_ptr(), m, MAX_PROBES, slot.data_ptr(), is_new.data_ptr(),
        n_new.data_ptr(), overflow.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_rc(lib, rc, "hash probe kernel launch")
    LAUNCHES += 1
    return is_new, n_new, overflow


def probe_insert(table, q, valid):
    """Insert-or-find (see hashset.probe_insert): -> (table, is_new bool[M],
    n_new scalar, overflow bool scalar); the table is updated in place."""
    if table.device.type == "cpu":
        return probe_insert_plain(table, q, valid)
    is_new, n_new, overflow = launch(table, q, valid.to(torch.uint8))
    return table, is_new.bool(), n_new[0].to(torch.int64), overflow[0] != 0


def _lib():
    lib = build.library("hashset")
    fn = lib.kspec_probe_insert
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, ll, p, p, ll, ctypes.c_int, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib
