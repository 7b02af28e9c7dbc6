"""Kernel K4: the six rungs of the construct ladder.

Counterpart of ``scripts/tpu_mosaic_ladder.py`` (:45-133).  Each rung is one
construct over u32[n], from a pure vector op down to a data-dependent scalar
store and a scalar walk.  On the TPU the ladder found which Pallas
constructs its compile path took; on the card each rung measures what its
construct costs.  At the ladder's n = 256 a rung moves 2 KB, so its time is
the launch floor; at n = 2^24 (134 MB read and written, beyond the 50 MB
L2) it is one memory-bound pass.  The CUDA source is ``csrc/ladder.cu``;
its header gives the design (one 16-byte vector a thread; four 4-byte
elements a thread for ``scalar_loop`` and for a view off a 16-byte
boundary).

``run(rung, x)`` is the entry point of one rung.  On a CPU tensor it runs
the plain version, ``PLAIN[rung]``; on a CUDA tensor it launches the kernel
on the tensor's card, through ``build``'s launch route, or raises.
``run_ladder`` runs the JAX script's path: ``arange(n)`` through every
rung, each compared with its plain version and timed
(``utils/kernel_times.py::rung_times``).  ``LAUNCHES`` counts each rung's
kernel launches.

Semantics of every rung, as the Pallas bodies compute them: values are u32
(carried in int64 here, as int32 bit patterns on the kernel's side) and all
arithmetic is mod 2^32.  ``pos = min(x[0] % 7, n - 1)``: an unsigned
remainder, clamped because JAX's ``pl.ds`` clamps a start that is out of
range.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import HBM_BYTES_PER_S
from . import build
from .cuda_fingerprint import from_i32, to_i32
from .fingerprint import MASK32

RUNGS = ("vec", "loop_vec", "static_scalar", "dyn_read", "dyn_slice", "scalar_loop")
# line of each rung's Pallas body in the TPU script
REPLACES = {
    rung: f"scripts/tpu_mosaic_ladder.py:{line}"
    for rung, line in zip(RUNGS, (45, 48, 54, 58, 62, 67))
}
LAUNCHES = {rung: 0 for rung in RUNGS}
_INDEX = {rung: i for i, rung in enumerate(RUNGS)}
_p = ctypes.c_void_p
# rung, x, o, n, reps, device, stream
KSPEC_LADDER = build.Entry(
    "ladder", "kspec_ladder",
    (ctypes.c_int, _p, _p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _p))


def _pos(x: torch.Tensor) -> torch.Tensor:
    """int64[1]: x[0] % 7 clamped to the last index, on x's device."""
    return torch.clamp(x[:1] % 7, max=x.shape[0] - 1)


def vec_plain(x):
    return (x * 3 + 7) & MASK32


def loop_vec_plain(x):
    acc = torch.zeros_like(x)
    for _ in range(4):
        acc = (acc + x) & MASK32
    return acc


def static_scalar_plain(x):
    o = x.clone()
    o[:1] = (x[:1] + 1) & MASK32
    return o


def dyn_read_plain(x):
    return (x + x[_pos(x)]) & MASK32


def dyn_slice_plain(x):
    o = x.clone()
    pos = _pos(x)
    o[pos] = (x[pos] + 1) & MASK32
    return o


def scalar_loop_plain(x):
    return (x + 1) & MASK32


PLAIN = dict(zip(RUNGS, (vec_plain, loop_vec_plain, static_scalar_plain,
                         dyn_read_plain, dyn_slice_plain, scalar_loop_plain)))


def _check_rung(rung: str) -> None:
    if rung not in _INDEX:
        raise ValueError(f"unknown rung {rung!r}; the rungs are {RUNGS}")


def _check_x32(x32: torch.Tensor) -> None:
    if not x32.is_cuda:
        raise ValueError(f"kernel K4 needs CUDA tensors, got {x32.device}")
    if x32.dtype is not torch.int32 or x32.dim() != 1 or not 1 <= x32.shape[0] < 1 << 31:
        raise ValueError(f"x must be int32[n], 1 <= n < 2^31, got {x32.dtype}{list(x32.shape)}")


def _launch(rung: str, x32: torch.Tensor, out: torch.Tensor, reps: int) -> None:
    index = x32.get_device()
    rc = KSPEC_LADDER.call(_INDEX[rung], x32.data_ptr(), out.data_ptr(), x32.shape[0],
                           reps, index, build.stream_handle(index))
    if rc:
        raise KSPEC_LADDER.error(rc, f"ladder kernel launch ({rung})")
    LAUNCHES[rung] += reps


def launch(rung: str, x32: torch.Tensor) -> torch.Tensor:
    """The kernel itself: int32[n] bit patterns on the card -> int32[n],
    launched on x32's card and its current stream."""
    _check_x32(x32)
    _check_rung(rung)
    x32 = x32.contiguous()
    out = torch.empty_like(x32)
    _launch(rung, x32, out, 1)
    return out


def launch_repeated(rung: str, x32: torch.Tensor, out: torch.Tensor, reps: int) -> None:
    """`reps` launches of the rung back to back from one C call, into `out`:
    the card's launch-to-launch time with no Python between launches."""
    _check_x32(x32)
    _check_rung(rung)
    n = x32.shape[0]
    if not (x32.is_contiguous() and out.is_contiguous() and out.shape == x32.shape
            and out.dtype is torch.int32 and out.get_device() == x32.get_device()):
        raise ValueError("x and out must be contiguous int32[n] on one device")
    if abs(out.data_ptr() - x32.data_ptr()) < 4 * n:
        raise ValueError("out must not overlap x")
    _launch(rung, x32, out, reps)


def run(rung: str, x: torch.Tensor) -> torch.Tensor:
    """One rung on u32 values held in int64[n]: the plain version for a CPU
    tensor, the kernel for a CUDA tensor."""
    _check_rung(rung)
    if x.dtype != torch.int64 or x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be int64[n] with n >= 1, got {x.dtype}{list(x.shape)}")
    if x.device.type == "cpu":
        return PLAIN[rung](x)
    return from_i32(launch(rung, to_i32(x)))


def library_call(rung: str, x32: torch.Tensor):
    """One PyTorch call that computes the rung on the int32 bit patterns, as
    a function of no arguments (its constants made here, outside the call, no
    larger than one element, so that the call reads x and writes its output
    as the kernel does), or None where there is none.  Timed beside the
    kernel, used nowhere else."""
    if rung == "vec":
        # a 0-dim CPU tensor: passed to the card's kernel as an argument, so
        # that x is its only input (a 0-dim card tensor is a second input of
        # stride 0, which keeps torch off its vectorized path)
        seven = torch.tensor(7, dtype=torch.int32)
        return lambda: torch.add(seven, x32, alpha=3)
    if rung == "loop_vec":
        return lambda: torch.mul(x32, 4)
    if rung == "static_scalar":
        at0, one = x32.new_zeros(1, dtype=torch.int64), x32.new_ones(1)
        return lambda: torch.index_add(x32, 0, at0, one)
    if rung == "scalar_loop":
        return lambda: torch.add(x32, 1)
    return None  # dyn_read and dyn_slice take pos from the data


def bound(n: int) -> tuple[float, str]:
    """Least time on the card of any rung at n elements, ms: each input byte
    read once, each output byte written once.  A rung does at most four
    integer operations an element, some 40x less time than its bytes."""
    return 8 * n / HBM_BYTES_PER_S * 1e3, "bytes"


def _without_kernel(rung: str, n: int, ok: bool, error) -> dict:
    """A record whose kernel did not run: on the CPU, or after a failure."""
    bound_ms, bound_by = bound(n)
    return {"rung": rung, "ok": ok, "error": error, "max_abs_err": None,
            "ms": None, "plain_ms": None, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "launches": None}


def run_ladder(device=None, n: int = 256, emit=None) -> list[dict]:
    """The TPU script's path: arange(n) u32 through every rung, in order.

    On the card (the default) each rung is launched once, compared bit for
    bit with its plain version and then timed; on the CPU only the plain
    versions run and the kernel fields are None.  Returns one record per
    rung, and hands each to `emit` as soon as its rung has run.  A rung that
    raises ends the ladder (a CUDA fault leaves the context unusable): it
    and every later rung get ok False and the error.
    """
    from ..utils import kernel_times

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ladder runs on the card "
                           "by default; pass device='cpu' for the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    x = torch.arange(n, dtype=torch.int64, device=dev)
    records, failed = [], None
    for rung in RUNGS:
        if failed is not None:
            rec = _without_kernel(rung, n, False, f"not run: rung {failed} failed first")
        elif dev.type == "cpu":
            run(rung, x)
            rec = _without_kernel(rung, n, True, None)
        else:
            try:
                before = LAUNCHES[rung]
                out = run(rung, x)
                torch.cuda.synchronize(dev)  # a fault in the rung shows here
                launches = LAUNCHES[rung] - before
                ref = PLAIN[rung](x)
                err = int((out - ref).abs().max())
                rec = {"rung": rung, "ok": err == 0, "error": None, "max_abs_err": err,
                       **kernel_times.rung_times(rung, x, ref)}
                rec["bound_ms"], rec["bound_by"] = bound(n)
                rec["launches"] = launches
            except RuntimeError as e:  # build error or CUDA error: bank it, stop
                failed = rung
                rec = _without_kernel(rung, n, False, f"{type(e).__name__}: {str(e)[:400]}")
        records.append(rec)
        if emit is not None:
            emit(rec)
    return records

