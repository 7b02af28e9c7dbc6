"""Append-only on-disk parent log: counterexample traces without RAM.

The port's own copy of ``kafka_specification_tpu/storage/parent_log.py``,
writing the same files byte for byte.

The in-RAM trace store keeps every level's (rows, parent, action) triple
alive for the whole run, and a checkpointed run without the disk tier
keeps none (its violations after a resume have an empty trace).  The
parent log moves the triple to disk as one CRC-framed
segment per BFS level, written in discovery order as the level is
assembled; `walk_trace` then reconstructs a violation path by reading
O(depth) single records back through the mmap'd segments instead of
holding parent arrays in RAM.

Because segments for levels <= the checkpointed depth are immutable and
the resumed re-exploration is deterministic (identical discovery order),
a resumed run simply overwrites any partially-written post-checkpoint
segments with identical bytes — so a violation found AFTER a resume still
reports the full root->violation trace.

``ShardedParentLog`` (per-shard logs for the sharded engine) is not
ported yet.

Segment format (`level-NNNNN.plog`): 256-byte JSON header
{magic, n, lanes, crc_rows, crc_parent, crc_act} padded with spaces, then
rows (n x lanes u32), parent (n i64), act (n i32), each section CRC32'd.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from .atomic import atomic_write, sweep_tmp

_HDR_LEN = 256
_MAGIC = "KPLG1"


class ParentLogCorrupt(Exception):
    """A parent-log level segment failed verification."""


def _level_name(level: int) -> str:
    return f"level-{level:05d}.plog"


class _LevelView:
    """(rows, parent, act) mmap triple for one level — the same tuple
    shape the in-RAM trace store holds, so `walk_trace` is shared."""

    def __init__(self, path: str):
        try:
            with open(path, "rb") as fh:
                hdr = json.loads(fh.read(_HDR_LEN).decode("ascii").strip())
        except (OSError, ValueError) as e:
            raise ParentLogCorrupt(f"{path}: unreadable header ({e})") from e
        if hdr.get("magic") != _MAGIC:
            raise ParentLogCorrupt(f"{path}: bad magic")
        n, K = int(hdr["n"]), int(hdr["lanes"])
        off = _HDR_LEN
        want = off + 4 * n * K + 8 * n + 4 * n
        if os.path.getsize(path) != want:
            raise ParentLogCorrupt(f"{path}: truncated")
        self.rows = np.memmap(path, np.uint32, "r", offset=off, shape=(n, K))
        off += 4 * n * K
        self.parent = np.memmap(path, np.int64, "r", offset=off, shape=(n,))
        off += 8 * n
        self.act = np.memmap(path, np.int32, "r", offset=off, shape=(n,))
        for name, arr, crc in (
            ("rows", self.rows, hdr["crc_rows"]),
            ("parent", self.parent, hdr["crc_parent"]),
            ("act", self.act, hdr["crc_act"]),
        ):
            if zlib.crc32(arr.tobytes()) != int(crc):
                raise ParentLogCorrupt(f"{path}: {name} CRC mismatch")


class ParentLog:
    def __init__(self, directory: str, lanes: int, fault_plan=None):
        self.dir = directory
        self.K = int(lanes)
        self.fault_plan = fault_plan  # enospc@plog:N injection
        self._parts: list = []  # buffered (rows, parent, act) per append
        self._level = None
        os.makedirs(directory, exist_ok=True)
        sweep_tmp(directory)  # mid-write death janitor (storage/atomic)

    # --- write side -----------------------------------------------------
    def begin_level(self, level: int) -> None:
        self._level = int(level)
        self._parts = []

    def append(self, rows, parent, act) -> None:
        if rows.shape[0] == 0:
            return
        self._parts.append(
            (
                np.ascontiguousarray(rows, np.uint32),
                np.ascontiguousarray(parent, np.int64),
                np.ascontiguousarray(act, np.int32),
            )
        )

    def end_level(self) -> None:
        """Frame + atomically publish the buffered level segment.  A
        pre-existing segment (a resumed run re-exploring) is overwritten —
        deterministic discovery order makes the bytes identical."""
        rows = (
            np.concatenate([p[0] for p in self._parts])
            if self._parts
            else np.empty((0, self.K), np.uint32)
        )
        parent = (
            np.concatenate([p[1] for p in self._parts])
            if self._parts
            else np.empty(0, np.int64)
        )
        act = (
            np.concatenate([p[2] for p in self._parts])
            if self._parts
            else np.empty(0, np.int32)
        )
        hdr = {
            "magic": _MAGIC,
            "n": int(rows.shape[0]),
            "lanes": self.K,
            "crc_rows": zlib.crc32(rows.tobytes()),
            "crc_parent": zlib.crc32(parent.tobytes()),
            "crc_act": zlib.crc32(act.tobytes()),
        }
        blob = json.dumps(hdr).encode("ascii")
        assert len(blob) < _HDR_LEN, "parent-log header overflow"
        path = os.path.join(self.dir, _level_name(self._level))
        hook = None
        if self.fault_plan is not None:
            level = self._level

            def hook():
                # full-disk rehearsal (enospc@plog:N): pre-promote, so the
                # published log still ends at the last complete level
                self.fault_plan.enospc("plog", level)

        def write(fh):
            fh.write(blob.ljust(_HDR_LEN))
            fh.write(rows.tobytes())
            fh.write(parent.tobytes())
            fh.write(act.tobytes())

        atomic_write(path, write, before_replace=hook)
        self._parts = []
        self._level = None

    def write_level(self, level, rows, parent, act) -> None:
        """Convenience: a whole level in one shot (level 0 = inits)."""
        self.begin_level(level)
        self.append(rows, parent, act)
        self.end_level()

    # --- read side ------------------------------------------------------
    def has_levels(self, upto: int) -> bool:
        return all(
            os.path.exists(os.path.join(self.dir, _level_name(d)))
            for d in range(upto + 1)
        )

    def view(self) -> "ParentLog._View":
        return ParentLog._View(self.dir)

    class _View:
        """Indexable like the in-RAM trace store: view[d] -> the level-d
        (rows, parent, act) triple, CRC-verified on open."""

        def __init__(self, directory: str):
            self.dir = directory

        def __getitem__(self, level: int):
            lv = _LevelView(os.path.join(self.dir, _level_name(level)))
            return lv.rows, lv.parent, lv.act
