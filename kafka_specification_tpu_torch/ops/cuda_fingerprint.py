"""Kernel K1: fused murmur3 fingerprinting of packed state rows.

Replaces ``kafka_specification_tpu/ops/pallas_fingerprint.py``
(``fingerprint_pallas``).  The CUDA source is ``csrc/fingerprint.cu``; its
header says what bounds it on the card.

``fingerprint(lanes, valid)`` is the entry point.  On a CPU tensor it runs
the plain version, ``fingerprint_plain``; on a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dedup import SENT
from .fingerprint import MASK32, hash_pair

LAUNCHES = 0


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


def launch(lanes32: torch.Tensor, valid8: torch.Tensor):
    """The kernel itself: int32[M, K] x uint8[M] on the card -> (hi, lo)
    int32[M] bit patterns."""
    global LAUNCHES
    if lanes32.device.type != "cuda":
        raise ValueError(f"kernel K1 needs CUDA tensors, got {lanes32.device}")
    if lanes32.dtype != torch.int32 or lanes32.dim() != 2:
        raise ValueError(f"lanes must be int32[M, K], got {lanes32.dtype}{list(lanes32.shape)}")
    if valid8.dtype != torch.uint8 or valid8.shape != lanes32.shape[:1]:
        raise ValueError("valid must be uint8[M] beside lanes")
    if valid8.device != lanes32.device:
        raise ValueError("lanes and valid on different devices")
    lanes32 = lanes32.contiguous()
    valid8 = valid8.contiguous()
    m, k = lanes32.shape
    hi = torch.empty(m, dtype=torch.int32, device=lanes32.device)
    lo = torch.empty(m, dtype=torch.int32, device=lanes32.device)
    if m == 0:
        return hi, lo
    lib = _lib()
    rc = lib.kspec_fingerprint(
        lanes32.data_ptr(), valid8.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        m, k, torch.cuda.current_stream(lanes32.device).cuda_stream,
    )
    build.check_rc(lib, rc, "fingerprint kernel launch")
    LAUNCHES += 1
    return hi, lo


def fingerprint(lanes: torch.Tensor, valid: torch.Tensor):
    """int64[M, K] u32 lanes x bool[M] -> (hi, lo) int64[M] u32 values,
    with the sentinel pair for invalid rows."""
    if lanes.device.type == "cpu":
        return fingerprint_plain(lanes, valid)
    hi, lo = launch(to_i32(lanes), valid.to(torch.uint8))
    return from_i32(hi), from_i32(lo)


def _lib():
    lib = build.library("fingerprint")
    fn = lib.kspec_fingerprint
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib
