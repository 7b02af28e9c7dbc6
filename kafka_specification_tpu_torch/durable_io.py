"""The one recordable interposition layer for durable filesystem effects.

The port's copy of ``kafka_specification_tpu/durable_io.py``.  Every
durable publish of the port flows through a handful of idioms: the two
atomic helpers (``storage/atomic.py``, ``obs/atomicio.py``), the O_APPEND
journal emitters (``resilience/heartbeat.py``, ``obs/metrics.py``,
``obs/fleettrace.py``), and the bare rename/replace/unlink protocol steps
of the queue, router, state-cache, checkpoint and spill layers.  This
module gives all of them one vocabulary of primitives plus an optional
*recorder*, so the crash-consistency harness (``resilience/crashcheck``)
can capture the exact op-trace a scenario issues and then enumerate every
legal post-crash filesystem state at every prefix of that trace, and an
optional *fault hook*, through which the fleet simulation
(``resilience/simfleet``) fails an op before it takes effect.

With no recorder and no hook installed (the production default) every
wrapper is a direct pass-through to ``os``: two ``is None`` checks of
overhead, no change of behaviour.  Recording never alters the effects
either: ops are logged *after* they succeed, and the recorder only ever
reads files back, never writes.  The recorder appends under a lock, so it
takes ops from any thread (the overlap layer's async checkpoint writer
saves from its worker thread).

Op vocabulary (what the crash model reasons about):

``write``      whole-file content landed (tmp or in-place); ``fsynced``
               says whether the *data* is durable independent of any
               later rename
``append``     one O_APPEND record; appended data is never fsync'd, so
               the tail is always torn-able
``rename``     directory-entry op; durable only once the destination
               directory has been fsync'd (``fsync_dir``)
``unlink``     directory-entry op, same durability rule
``fsync_dir``  flushes every pending directory-entry op under that dir
``ack``        not a filesystem op: a scenario-level acknowledgement
               marker ("the client was told X"); invariants conditional
               on an ack apply only to crash points after it

Leaf contract: standard library only, no import of the package.  Both
atomic helpers import this module, so it must never pull numpy or torch.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "OpRecorder", "install", "recording",
    "replace", "rename", "unlink", "fsync_dir",
    "write_text", "append_text",
    "note_write", "note_append", "ack",
    "sweep_tmp", "set_fault_hook",
]

_LOCK = threading.Lock()
_RECORDER = None  # None in production: every wrapper is a pass-through
_FAULT_HOOK = None  # None in production: doing wrappers never inject

#: grace age for sweeping orphan tmps out of MULTI-writer directories
#: (queue state dirs, router routes, sweep manifests): a live writer's
#: in-flight tmp is milliseconds old, so only a tmp at least this stale
#: can be a mid-write death's orphan.  Single-owner structures sweep
#: with min_age_s=0 at open.
TMP_SWEEP_GRACE_S = float(os.environ.get("KSPEC_TMP_SWEEP_GRACE_S", "60"))


class OpRecorder:
    """Collects the op-trace of every durable effect under ``root``.

    Paths are stored root-relative with ``/`` separators; ops touching
    only paths outside the root are dropped (scratch files, unrelated
    tmpdirs).  ``ops`` is a list of plain dicts — the crash model and
    the machine-readable finding repro both consume it as-is."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.ops = []

    def rel(self, path: str):
        p = os.path.abspath(path)
        if p == self.root:
            return "."
        prefix = self.root + os.sep
        if not p.startswith(prefix):
            return None
        return p[len(prefix):].replace(os.sep, "/")

    def record(self, op: str, **fields) -> None:
        entry = {"op": op}
        for k, v in fields.items():
            if k in ("path", "src", "dst"):
                v = self.rel(v)
                if v is None:
                    return  # outside the recorded root: not ours
            entry[k] = v
        with _LOCK:
            self.ops.append(entry)

    def ack(self, label: str, **fields) -> None:
        """Scenario-level acknowledgement marker (see module docstring)."""
        with _LOCK:
            self.ops.append({"op": "ack", "label": label, **fields})


def install(recorder):
    """Install (or with ``None`` remove) the process-global recorder.
    Returns the previous recorder so callers can restore it."""
    global _RECORDER
    with _LOCK:
        prev = _RECORDER
        _RECORDER = recorder
    return prev


def recording() -> bool:
    return _RECORDER is not None


def _note(op: str, **fields) -> None:
    r = _RECORDER
    if r is not None:
        r.record(op, **fields)


# --- pure recording hooks (no filesystem effect of their own) -------------


def note_write(path: str, fsynced: bool) -> None:
    """Record that ``path`` now holds the bytes on disk (the caller just
    wrote and closed it).  Reads the file back ONLY when recording."""
    r = _RECORDER
    if r is None:
        return
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return
    r.record("write", path=path, data=data, fsynced=bool(fsynced))


def note_append(path: str, data) -> None:
    """Record one O_APPEND emit of ``data`` (bytes or str) to ``path``."""
    r = _RECORDER
    if r is None:
        return
    if isinstance(data, str):
        data = data.encode("utf-8", "replace")
    r.record("append", path=path, data=data)


def ack(label: str, **fields) -> None:
    """Scenario acknowledgement marker — no-op unless recording."""
    r = _RECORDER
    if r is not None:
        r.ack(label, **fields)


# --- fault injection seam (simfleet's flaky-fs model) ---------------------


def set_fault_hook(hook):
    """Install (``None`` removes) a callable ``hook(op, path) -> None``
    consulted at the START of every doing wrapper, before the effect.
    Raising ``OSError`` from the hook makes the op fail cleanly (nothing
    happened on disk) — the flaky-filesystem model the deterministic
    fleet simulation (``resilience/simfleet``) drives, exercising every
    ``retry_transient`` envelope in virtual time.  Returns the previous
    hook.  Production default ``None``: one ``is None`` check per op."""
    global _FAULT_HOOK
    with _LOCK:
        prev = _FAULT_HOOK
        _FAULT_HOOK = hook
    return prev


def _fault(op: str, path: str) -> None:
    h = _FAULT_HOOK
    if h is not None:
        h(op, path)


# --- doing wrappers (perform the effect, then record it) ------------------


def replace(src: str, dst: str) -> None:
    _fault("rename", dst)
    os.replace(src, dst)
    _note("rename", src=src, dst=dst)


def rename(src: str, dst: str) -> None:
    _fault("rename", dst)
    os.rename(src, dst)
    _note("rename", src=src, dst=dst)


def unlink(path: str) -> None:
    _fault("unlink", path)
    os.unlink(path)
    _note("unlink", path=path)


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry (some filesystems refuse
    O_RDONLY dir fsync; the data-file fsync already happened either
    way).  Recorded even when the fsync itself is refused: the caller
    *issued* the barrier, which is what the crash model checks for."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        _note("fsync_dir", path=path or ".")
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
    _note("fsync_dir", path=path or ".")


def write_text(path: str, text: str, fsync: bool = False) -> None:
    """In-place (non-atomic) whole-file text write, recorded.  For
    sidecars whose torn state is tolerated by every reader (claim
    leases, tenant admission markers) — anything a reader must never
    see torn goes through an atomic helper instead."""
    _fault("write", path)
    with open(path, "w") as fh:
        fh.write(text)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    note_write(path, fsynced=fsync)


def append_text(path: str, text: str) -> None:
    """One buffered O_APPEND text emit, recorded."""
    _fault("append", path)
    with open(path, "a") as fh:
        fh.write(text)
    note_append(path, text)


# --- the shared startup janitor ------------------------------------------


def sweep_tmp(directory: str, min_age_s: float = 0.0) -> list:
    """Startup janitor: remove stale ``.tmp`` siblings (``x.tmp``,
    ``x.<nonce>.tmp``, ``x.tmp.npz`` checkpoint tmps) left by a
    mid-write death.  Safe by construction — no manifest ever references
    a tmp name.  ``min_age_s > 0`` (pass :data:`TMP_SWEEP_GRACE_S`)
    spares young tmps for the multi-writer directories where a sibling
    may legitimately be mid-promote right now.  Returns the removed
    paths.  ``storage.atomic.sweep_tmp`` re-exports it."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    now = None
    for name in os.listdir(directory):
        if not (name.endswith(".tmp") or ".tmp." in name):
            continue
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            continue
        if min_age_s > 0.0:
            if now is None:
                import time

                now = time.time()
            try:
                if now - os.path.getmtime(p) < min_age_s:
                    continue  # possibly a live writer's in-flight tmp
            except OSError:
                continue  # promoted or collected under us: not an orphan
        try:
            os.unlink(p)
            removed.append(p)
        except OSError:
            pass
    return removed
