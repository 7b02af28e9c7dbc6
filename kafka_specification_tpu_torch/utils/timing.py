"""Device times on the card, and the H100 peak rates a bound is held to.

The one timing helper of the port: ``chip_smoke.py``,
``ops/cuda_ladder.py::run_ladder`` and ``scripts/cuda_kernel_ladder.py``
time with it.  Nothing on the check path times itself.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit integer operations, counted against the data sheet's 67 TFLOP/s
# fp32 rate outside the tensor cores (the int32 rate is not higher)
OPS_PER_S = 67e12


def cuda_call_ms(fn, iters, setup=None) -> list[float]:
    """Device time of fn() in ms for each of `iters` runs on an idle card,
    CUDA events around each call only (setup() runs outside the window and
    its result is fn's argument)."""
    fn() if setup is None else fn(setup())  # warm-up
    times = []
    for _ in range(iters):
        arg = None if setup is None else setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn() if setup is None else fn(arg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def cuda_ms(fn, iters, setup=None) -> float:
    """Mean of cuda_call_ms."""
    return sum(cuda_call_ms(fn, iters, setup)) / iters


def back_to_back_ms(fn, iters) -> float:
    """Device time per call of fn() in ms: CUDA events around `iters` calls
    issued back to back, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters
