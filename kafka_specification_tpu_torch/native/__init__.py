"""The host fingerprint set (C++, bound with ctypes): the visited set of
``check(..., visited_backend="host")``.

The port's own copy of ``kafka_specification_tpu/native/`` (``fpset.cpp``
and its binding): a host-side open-addressing set of 64-bit fingerprints,
for state spaces whose fingerprints outgrow device memory.

``fpset.cpp`` is compiled by ``g++ -O2`` at first use, never at import,
into ``build/native/`` at the root of the checkout, named by a hash of the
source (so an edited source is rebuilt and a stale library never loaded).
Where there is no g++, or it refuses the source, ``FpSet`` raises
``NativeBuildError``: there is no fallback.  ``PlainFpSet`` is the plain
version, a Python set with the same interface, which the tests hold the
native set against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fpset.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FAILED = np.iinfo(np.uint64).max  # the C entries' "allocation failed"

_lock = threading.Lock()
_lib = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "fpset_create": (ctypes.c_void_p, [ctypes.c_uint64]),
    "fpset_destroy": (None, [ctypes.c_void_p]),
    "fpset_count": (ctypes.c_uint64, [ctypes.c_void_p]),
    "fpset_capacity": (ctypes.c_uint64, [ctypes.c_void_p]),
    "fpset_insert_batch": (ctypes.c_uint64, [ctypes.c_void_p, _u64p, ctypes.c_uint64, _u8p]),
    "fpset_insert_compact": (ctypes.c_uint64, [
        ctypes.c_void_p, _u32p, _u32p, ctypes.c_uint64, _u32p, ctypes.c_uint64,
        _i32p, ctypes.c_int64, _i32p, _u32p, _i64p, _i32p,
    ]),
    "fpset_contains_batch": (None, [ctypes.c_void_p, _u64p, ctypes.c_uint64, _u8p]),
    "fpset_dump": (ctypes.c_uint64, [ctypes.c_void_p, _u64p, ctypes.c_uint64]),
}


class NativeBuildError(RuntimeError):
    """g++ is missing or refused fpset.cpp."""


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfpset-{digest}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the host fingerprint set (native/fpset.cpp) "
            "cannot be built, so visited_backend='host' is unavailable"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed on native/fpset.cpp:\n{proc.stderr}")
    # kspec: allow(durable-io) a built host library, rebuilt from source
    # when missing; not durable state.  Atomic: a loader never sees half a file
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded fpset library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _u64(fps) -> np.ndarray:
    return np.ascontiguousarray(fps, dtype=np.uint64)


def _check_compact_args(hi, lo, rows, parent, act, arena_rows, arena_parent, arena_act):
    n = hi.shape[0]
    if lo.shape[0] != n or rows.ndim != 2 or any(
            a.shape[0] != n for a in (rows, parent, act)):
        raise ValueError(f"lo {lo.shape}, rows {rows.shape}, parent {parent.shape} and "
                         f"act {act.shape} must have the {n} rows of hi")
    if arena_rows.ndim != 2 or arena_rows.shape[1] != rows.shape[1]:
        raise ValueError(f"arena rows {arena_rows.shape} do not match rows {rows.shape}")
    # room for the all-novel worst case: the C pass writes unchecked
    if min(arena_rows.shape[0], arena_parent.shape[0], arena_act.shape[0]) < n:
        raise ValueError(f"the arena has no room for {n} rows")


class FpSet:
    """64-bit fingerprint set, native.  insert(fps) -> bool mask of novel
    entries (of in-batch duplicates only the first reports new)."""

    def __init__(self, initial_capacity: int = 1 << 16):
        self._lib = library()
        self._h = self._lib.fpset_create(initial_capacity)
        if not self._h:
            raise MemoryError("fpset_create failed")

    def insert(self, fps) -> np.ndarray:
        fps = _u64(fps)
        out = np.empty(fps.shape[0], dtype=np.uint8)
        rc = self._lib.fpset_insert_batch(
            self._h, fps.ctypes.data_as(_u64p), fps.shape[0], out.ctypes.data_as(_u8p))
        if rc == _FAILED:
            raise MemoryError("fpset grow failed")
        return out.astype(bool)

    def insert_compact(self, hi, lo, rows, parent, parent_base: int, act,
                       arena_rows, arena_parent, arena_act) -> int:
        """Fused insert + novel-row compaction: inserts fp = hi << 32 | lo
        per candidate and, for the novel ones, appends rows[i],
        parent[i] + parent_base and act[i] to the arena slices (uint32[., K],
        int64, int32, C-contiguous, with room for len(hi) rows).  Returns the
        number of rows appended."""
        hi = np.ascontiguousarray(hi, np.uint32)
        lo = np.ascontiguousarray(lo, np.uint32)
        rows = np.ascontiguousarray(rows, np.uint32)
        parent = np.ascontiguousarray(parent, np.int32)
        act = np.ascontiguousarray(act, np.int32)
        n = hi.shape[0]
        _check_compact_args(hi, lo, rows, parent, act, arena_rows, arena_parent, arena_act)
        for a, dt in ((arena_rows, np.uint32), (arena_parent, np.int64), (arena_act, np.int32)):
            if a.dtype != dt or not a.flags.c_contiguous:
                raise ValueError(f"arena slices must be C-contiguous {dt.__name__}, got {a.dtype}")
        w = self._lib.fpset_insert_compact(
            self._h, hi.ctypes.data_as(_u32p), lo.ctypes.data_as(_u32p), n,
            rows.ctypes.data_as(_u32p), rows.shape[1], parent.ctypes.data_as(_i32p),
            parent_base, act.ctypes.data_as(_i32p), arena_rows.ctypes.data_as(_u32p),
            arena_parent.ctypes.data_as(_i64p), arena_act.ctypes.data_as(_i32p))
        if w == _FAILED:
            raise MemoryError("fpset grow failed")
        return int(w)

    def contains(self, fps) -> np.ndarray:
        fps = _u64(fps)
        out = np.empty(fps.shape[0], dtype=np.uint8)
        self._lib.fpset_contains_batch(
            self._h, fps.ctypes.data_as(_u64p), fps.shape[0], out.ctypes.data_as(_u8p))
        return out.astype(bool)

    def __len__(self) -> int:
        return int(self._lib.fpset_count(self._h))

    def dump(self) -> np.ndarray:
        """Every fingerprint in the set, in slot order."""
        n = len(self)
        out = np.empty(n, dtype=np.uint64)
        w = self._lib.fpset_dump(self._h, out.ctypes.data_as(_u64p), n)
        return out[:w]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fpset_destroy(h)
            self._h = None


class PlainFpSet:
    """The plain version of FpSet: a Python set, the same interface and the
    same novelty rule.  The tests hold the native set against it; the
    engine never uses it."""

    def __init__(self, initial_capacity: int = 1 << 16):
        self._py = set()

    def insert(self, fps) -> np.ndarray:
        out = np.empty(len(fps), dtype=bool)
        for i, fp in enumerate(_u64(fps).tolist()):
            out[i] = fp not in self._py
            self._py.add(fp)
        return out

    def insert_compact(self, hi, lo, rows, parent, parent_base: int, act,
                       arena_rows, arena_parent, arena_act) -> int:
        hi, lo = np.asarray(hi, np.uint32), np.asarray(lo, np.uint32)
        rows = np.asarray(rows, np.uint32)
        parent, act = np.asarray(parent), np.asarray(act)
        _check_compact_args(hi, lo, rows, parent, act, arena_rows, arena_parent, arena_act)
        new = self.insert((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64))
        w = int(new.sum())
        arena_rows[:w] = rows[new]
        arena_parent[:w] = parent[new].astype(np.int64) + parent_base
        arena_act[:w] = act[new]
        return w

    def contains(self, fps) -> np.ndarray:
        return np.array([fp in self._py for fp in _u64(fps).tolist()], dtype=bool)

    def __len__(self) -> int:
        return len(self._py)

    def dump(self) -> np.ndarray:
        return np.fromiter(self._py, dtype=np.uint64, count=len(self._py))
