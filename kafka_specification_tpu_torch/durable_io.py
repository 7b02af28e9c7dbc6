"""Durable filesystem steps of the checkpoint store and the stats stream.

The port's own copy of the parts of ``kafka_specification_tpu/durable_io.py``
that checkpoints, the per-level stats lines and the serving plane's job
queue need: ``replace``, ``rename``, ``unlink``, ``fsync_dir``,
``write_text``, ``append_text`` and ``sweep_tmp``.  Each is a direct call into ``os``; the JAX module's op
recorder (its crash-consistency harness) and fault hook are not ported.

Stdlib only.
"""

from __future__ import annotations

import os
import time

#: how old a ``.tmp`` in a directory many processes write (the job queue)
#: must be before a janitor takes it for an orphan: a live writer promotes
#: well within it
TMP_SWEEP_GRACE_S = float(os.environ.get("KSPEC_TMP_SWEEP_GRACE_S", "60"))


def replace(src: str, dst: str) -> None:
    os.replace(src, dst)


def rename(src: str, dst: str) -> None:
    """One state transition of the job queue (``service/queue.py``)."""
    os.rename(src, dst)


def unlink(path: str) -> None:
    os.unlink(path)


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry (some filesystems refuse an
    O_RDONLY directory fsync; the data file's own fsync happened either
    way)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_text(path: str, text: str, fsync: bool = False) -> None:
    """In-place (non-atomic) whole-file text write."""
    with open(path, "w") as fh:
        fh.write(text)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())


def append_text(path: str, text: str) -> None:
    """One buffered O_APPEND text emit."""
    with open(path, "a") as fh:
        fh.write(text)


def sweep_tmp(directory: str, min_age_s: float = 0.0) -> list:
    """Startup janitor: remove stale ``.tmp`` siblings (``x.tmp``,
    ``x.<nonce>.tmp``, ``x.tmp.npz`` checkpoint tmps) left by a write that
    died midway; no manifest ever names a tmp.  ``min_age_s > 0`` spares
    tmps younger than that, which a live writer may be about to promote.
    Returns the removed paths."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    now = time.time()
    for name in os.listdir(directory):
        if not (name.endswith(".tmp") or ".tmp." in name):
            continue
        p = os.path.join(directory, name)
        if not os.path.isfile(p):
            continue
        try:
            if min_age_s > 0.0 and now - os.path.getmtime(p) < min_age_s:
                continue  # possibly a live writer's in-flight tmp
            os.unlink(p)
            removed.append(p)
        except OSError:
            pass  # promoted or collected under us: not an orphan
    return removed
