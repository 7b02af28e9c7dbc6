"""The one copy of the disk tier's crash-safety idiom.

The port's own copy of ``kafka_specification_tpu/storage/atomic.py``.
Every file this package publishes — runs, bloom sidecars, frontier
segments, parent-log levels — goes through the same sequence: write to a
`.tmp` sibling, flush + fsync, then atomically `os.replace` into the
final name, then fsync the parent directory so the *rename itself* is
durable.  A crash at any point leaves either the old file or no file,
never a torn one; a failed write (ENOSPC, injected or real) additionally
cleans up its own tmp so the directory stays exactly what the last
manifest describes.

`sweep_tmp` is the startup janitor for the one gap cleanup-on-raise
cannot cover: a process killed *mid-write* leaves its `.tmp` sibling
behind with no except block left to run.  Every storage structure sweeps
its directory at open — tmp files are never referenced by any manifest,
so removing them is always safe.
"""

from __future__ import annotations

import os

from .. import durable_io as _dio

fsync_dir = _dio.fsync_dir
sweep_tmp = _dio.sweep_tmp


def atomic_write(path: str, write_fn, before_replace=None,
                 tmp_nonce=None) -> None:
    """Write `path` crash-safely: `write_fn(fh)` fills the tmp file, then
    it is fsync'd, atomically promoted, and the parent directory entry is
    fsync'd.  `before_replace` (if given) runs between the durable tmp
    write and the promote — the torn-write fault-injection point
    (`KSPEC_FAULT=crash@merge:N` / `enospc@...:N`).  Any failure unlinks
    the tmp before propagating, so a caller that survives the error (the
    engine's RESOURCE_EXHAUSTED clean-exit path) leaves no orphan.

    `tmp_nonce` privatises the tmp name (`path.<nonce>.tmp`) for writers
    that race each other to the same final path."""
    tmp = path + ".tmp" if tmp_nonce is None else f"{path}.{tmp_nonce}.tmp"
    try:
        with open(tmp, "wb") as fh:
            write_fn(fh)
            fh.flush()
            os.fsync(fh.fileno())
        if before_replace is not None:
            before_replace()
        _dio.replace(tmp, path)
    except BaseException:
        try:
            _dio.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path))
