"""Build and load the port's CUDA kernels, and the one launch route that
every wrapper takes.

Each source in ``ops/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``.  Nothing is built when a module is imported: the first
wrapper call on a CUDA tensor builds what it needs, and ``build_all``
compiles every source at once, one ``nvcc`` process per source, all started
together.  Libraries land in ``build/kernels/`` at the root of the checkout,
named by a hash of their source, so an edited source is rebuilt and a stale
library is never loaded.  The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills of each kernel) is kept beside each library in a
``.log`` file.

The launch route.  A wrapper's call on the card pays for its checks, its
output allocation, the stream's raw handle, the C entry and the launch;
everything else is paid once:

- ``Entry`` binds one C entry at its first call (loads the library, sets
  ``argtypes``) and keeps the bound ctypes function in ``Entry.call``, so
  no later call goes through ``library()`` or tests ``argtypes``.  Nothing
  is bound, loaded or built at import.
- ``stream_handle(index)`` is the raw handle of PyTorch's current stream on
  card ``index``, from ``torch._C._cuda_getCurrentRawStream``, the binding
  PyTorch's own Inductor and Triton launchers call; the public
  ``torch.cuda.current_stream(dev).cuda_stream`` builds a ``Stream`` object
  each call.  The binding exists only in CUDA builds of PyTorch, so it is
  looked up at the first launch, never at import.
- Each C entry takes the card's index and launches there, putting the
  current device back, so a tensor on another card than the current one is
  launched on its own card with its own stream.
- A non-zero CUDA error code raises (``Entry.error``); there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fingerprint", "hashset", "ladder")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; -> (process, temporary output, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    # kspec: allow(durable-io) a built kernel library, rebuilt from source
    # when missing; not durable state.  Atomic: a loader never sees half a file
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source that is not built yet, all in parallel."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: library_path(n) for n in names}


def ptxas_report(name: str) -> str:
    """What nvcc -Xptxas -v said when it built `name`."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _loaded:
        path = build_all((name,))[name]
        lib = ctypes.CDLL(str(path))
        lib.kspec_error_string.argtypes = [ctypes.c_int]
        lib.kspec_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


class Entry:
    """One C entry of csrc/<lib>.cu, bound at its first call.

    ``entry.call(*args)`` calls the C function with ``argtypes`` and an int
    return (a CUDA error code).  Until the first call ``call`` is a method
    that binds the function and puts it in its own place, so every later
    call is the ctypes function itself."""

    def __init__(self, lib: str, name: str, argtypes):
        self.lib, self.name, self.argtypes = lib, name, list(argtypes)
        self.call = self._bind_and_call

    def bound(self) -> bool:
        return self.call != self._bind_and_call

    def _bind_and_call(self, *args):
        fn = getattr(library(self.lib), self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self.call = fn
        return fn(*args)

    def error(self, rc: int, what: str) -> RuntimeError:
        """The error to raise for a launch that returned CUDA error `rc`."""
        msg = library(self.lib).kspec_error_string(rc).decode()
        return RuntimeError(f"{what}: CUDA error {rc}: {msg}")


_raw_stream = None  # torch._C._cuda_getCurrentRawStream, once a launch needed it


def stream_handle(index: int) -> int:
    """The raw handle (cudaStream_t, as an int) of PyTorch's current stream
    on card `index`: what torch.cuda.current_stream(index).cuda_stream gives,
    without building a Stream object."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(index)
