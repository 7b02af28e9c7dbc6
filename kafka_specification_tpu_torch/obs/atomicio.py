"""Atomic file publication for the run directory's side-channel files.

The port's own copy of ``kafka_specification_tpu/obs/atomicio.py``: one
tmp + flush + (optional fsync) + ``os.replace`` + parent-dir fsync
sequence, shared by the run manifest (``obs/runctx.py``) and the
``metrics.prom`` textfile export (``obs/metrics.py``), so a reader never
sees a torn file.  The tmp's write is noted to ``durable_io``'s recorder
before the promote, so the crash harness sees it.

``fsync=True`` is for records whose loss would sever a lineage (a power
loss publishing an empty manifest mints a new run_id on reopen).
``fsync=False`` is for scrape artifacts; the parent-dir fsync is tied to
the same flag.

``tmp_nonce`` privatises the tmp name (``path.<nonce>.tmp``) for writers
that race each other to the same final path (router route records, sweep
manifests): with the shared ``path.tmp`` one racer could replace or unlink
the other's half-written tmp.  Nonce'd names still match ``sweep_tmp``.

Stdlib only.
"""

from __future__ import annotations

import json
import os

from .. import durable_io as _dio


def atomic_write_text(path: str, text: str, fsync: bool = True,
                      tmp_nonce: str = None) -> None:
    """Publish ``text`` at ``path`` atomically (tmp + replace + dir
    fsync).

    A reader re-opening ``path`` mid-write never sees a torn file; a
    failed write (ENOSPC mid-dump, KeyboardInterrupt) never leaves a
    stray ``.tmp`` behind; with ``fsync=True`` the publish survives a
    power loss (data fsync before the promote, directory fsync after)."""
    tmp = path + ".tmp" if tmp_nonce is None else f"{path}.{tmp_nonce}.tmp"
    try:
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        _dio.note_write(tmp, fsynced=fsync)
        _dio.replace(tmp, path)
    except BaseException:
        try:
            _dio.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        _dio.fsync_dir(os.path.dirname(path))


def atomic_write_json(path: str, obj: dict, fsync: bool = True,
                      tmp_nonce: str = None) -> None:
    """Publish ``obj`` as JSON at ``path`` atomically (and durably, unless
    ``fsync=False``)."""
    atomic_write_text(path, json.dumps(obj, indent=1, default=str), fsync=fsync,
                      tmp_nonce=tmp_nonce)
