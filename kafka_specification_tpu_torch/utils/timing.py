"""Device times on the card, the H100 peak rates a bound is held to, and
the card's name and power limit.

The one timing helper of the port: ``chip_smoke.py``,
``ops/cuda_ladder.py::run_ladder``, ``utils/kernel_times.py`` and the
scripts time with it.  Nothing on the check path times itself.
``ring_ms`` is a kernel's own time; ``cuda_call_ms`` around one call is its
route time, the host's work before the launch included.
"""

from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit integer operations, counted against the data sheet's 67 TFLOP/s
# fp32 rate outside the tensor cores (the int32 rate is not higher)
OPS_PER_S = 67e12


def card_line() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def host_us(fn, calls: int) -> float:
    """The host's time per call of fn() in us: a host clock around `calls`
    calls with no synchronize between them (few enough calls that the
    launch queue does not fill and hold the host back), after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def ring_ms(fn, make_ring, launches: int = 100) -> float:
    """A kernel's own device time per call in ms: CUDA events around
    `launches` calls fn(ring[i % len(ring)]) issued back to back, ring =
    make_ring() prepared outside the window.  A ring whose inputs a call
    consumes (a table it inserts into) needs `launches` entries.

    A sleep kernel queued ahead of the first event holds the card until the
    host has queued every call, so the window holds the card's work and its
    launch-to-launch gaps and none of the host's time per call.  If the host
    was still queueing when the sleep ended, the sleep is doubled and the
    run made again; after four tries it raises."""
    cycles = 1_000_000 * launches  # ~0.5 ms a call at the H100's clock
    for _ in range(4):
        ring = make_ring()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for i in range(launches):
            fn(ring[i % len(ring)])
        queued_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > queued_ms:
            return a.elapsed_time(b) / launches
        cycles *= 2
    raise RuntimeError(f"the host queued {launches} calls slower than the card ran them")
