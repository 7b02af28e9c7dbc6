"""Kernel K1: fused murmur3 fingerprinting of packed state rows.

Replaces ``kafka_specification_tpu/ops/pallas_fingerprint.py``
(``fingerprint_pallas``).  The CUDA source is ``csrc/fingerprint.cu``; its
header gives the design (lanes staged in shared memory by coalesced 16-byte
loads) and what bounds it on the card.

``fingerprint(lanes, valid)`` is the entry point.  On a CPU tensor it runs
the plain version, ``fingerprint_plain``; on a CUDA tensor it launches the
kernel on the port's int64 lanes and bool mask as they are, on their card,
through ``build``'s launch route, and runs nothing else on the card, or
raises.  ``LAUNCHES`` counts the kernel's launches.  ``to_i32``/``from_i32``
convert the u32-in-int64 carrier to int32 bit patterns and back for kernels
that take those (``cuda_ladder``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dedup import SENT
from .fingerprint import MASK32, hash_pair

LAUNCHES = 0
# lanes a row at most: a block stages 256 rows of K int64 words in shared
# memory, and a block may have 227 KB (232,448 bytes)
MAX_LANES = 232448 // (256 * 8)
_p = ctypes.c_void_p
# lanes, valid, hi, lo, m, k, device, stream
KSPEC_FINGERPRINT = build.Entry(
    "fingerprint", "kspec_fingerprint",
    (_p, _p, _p, _p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _p))


def fingerprint_plain(lanes: torch.Tensor, valid: torch.Tensor):
    """int64[M, K] u32 lanes x bool[M] -> (hi, lo) int64[M], invalid -> SENT."""
    hi, lo = hash_pair(lanes)
    return torch.where(valid, hi, SENT), torch.where(valid, lo, SENT)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> u32 values held in int64."""
    return x.to(torch.int64) & MASK32


def _check(lanes: torch.Tensor, valid: torch.Tensor):
    """-> (M, K, card index) of a call the kernel takes; raises otherwise."""
    if not lanes.is_cuda:
        raise ValueError(f"kernel K1 needs CUDA tensors, got {lanes.device}")
    if lanes.dtype is not torch.int64 or lanes.dim() != 2 or not lanes.is_contiguous():
        raise ValueError(f"lanes must be contiguous int64[M, K], got {lanes.dtype}{list(lanes.shape)}")
    m, k = lanes.shape
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"K = {k} lanes: the kernel takes 1 to {MAX_LANES}")
    index = lanes.get_device()
    if (valid.dtype is not torch.bool or valid.dim() != 1 or valid.shape[0] != m
            or valid.get_device() != index or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool[M] beside lanes")
    return m, k, index


def launch(lanes: torch.Tensor, valid: torch.Tensor):
    """The kernel itself: int64[M, K] u32 lanes x bool[M] on the card ->
    (hi, lo) int64[M] u32 values, the sentinel pair for invalid rows."""
    global LAUNCHES
    m, k, index = _check(lanes, valid)
    hi = lanes.new_empty(m)
    lo = lanes.new_empty(m)
    if m == 0:
        return hi, lo
    rc = KSPEC_FINGERPRINT.call(lanes.data_ptr(), valid.data_ptr(), hi.data_ptr(),
                                lo.data_ptr(), m, k, index, build.stream_handle(index))
    if rc:
        raise KSPEC_FINGERPRINT.error(rc, "fingerprint kernel launch")
    LAUNCHES += 1
    return hi, lo


def fingerprint(lanes: torch.Tensor, valid: torch.Tensor):
    """int64[M, K] u32 lanes x bool[M] -> (hi, lo) int64[M] u32 values,
    with the sentinel pair for invalid rows."""
    if lanes.is_cpu:
        return fingerprint_plain(lanes, valid)
    return launch(lanes, valid)

