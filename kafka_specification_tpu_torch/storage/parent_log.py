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

``ShardedParentLog`` keeps the sharded engine's per-shard logs, one
``ParentLog`` a shard under ``shard<d>/``, and the layout epochs of an
elastic resume (``epochs.json``).

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


class ShardedParentLog:
    """Per-shard parent logs for the sharded engine (+ layout epochs).

    A sharded level's global discovery order is shard-major: shard 0's
    new rows, then shard 1's, ...  Each shard appends its own
    (rows, parent, act) slice as an ordinary ParentLog segment under
    `shard<d>/`, so a multi-host run writes its logs in parallel with no
    cross-host file contention, and a reader re-concatenates the shard
    segments to recover exactly the in-RAM trace store's level layout —
    `walk_trace` is shared unchanged.  Parents are already level-global
    indices (the engine resolves them before appending), so they survive
    the concatenation untouched.

    An elastic resume changes the shard count mid-log,
    which changes the shard-major order from the resume level on:
    `epochs.json` records `[[start_level, shard_count], ...]`, each level
    is read through the epoch covering it, and `reshard()` rewrites the
    boundary level's segments into the new order (each row keeps its old
    (parent, act) — parents index the previous level, whose layout is
    unchanged), so one trace chain resolves across layouts.  Segments at
    or below a resume's level are immutable; the deterministic re-run
    overwrites later ones byte-identically (same argument as ParentLog).
    """

    def __init__(self, directory: str, lanes: int, shard_count: int,
                 local_shards=None, epoch_writer: bool = True,
                 fault_plan=None):
        self.dir = directory
        self.K = int(lanes)
        self.D = int(shard_count)
        self.fault_plan = fault_plan  # enospc@plog:N (per-shard writers)
        self.local = (
            set(range(self.D))
            if local_shards is None
            else {int(s) for s in local_shards}
        )
        # one writer per job for the (tiny, identical-everywhere) epoch
        # manifest: every process computes the same list in memory
        self.epoch_writer = bool(epoch_writer)
        self.epochs = None  # [[start_level, shard_count], ...]; None=broken
        self._logs: dict = {}
        os.makedirs(directory, exist_ok=True)

    # --- epochs ---------------------------------------------------------
    def _epochs_path(self) -> str:
        return os.path.join(self.dir, "epochs.json")

    def _load_epochs(self):
        try:
            with open(self._epochs_path()) as fh:
                return [[int(a), int(b)] for a, b in json.load(fh)["epochs"]]
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write_epochs(self) -> None:
        if not self.epoch_writer:
            return
        blob = json.dumps({"epochs": self.epochs}).encode("ascii")
        atomic_write(self._epochs_path(), lambda fh: fh.write(blob))

    def _epoch_D(self, level: int):
        D = None
        for start, d in self.epochs or ():
            if start <= level:
                D = d
        return D

    def _log(self, d: int) -> ParentLog:
        if d not in self._logs:
            self._logs[d] = ParentLog(
                os.path.join(self.dir, f"shard{d}"), self.K,
                fault_plan=self.fault_plan,
            )
        return self._logs[d]

    # --- lifecycle ------------------------------------------------------
    def start_fresh(self) -> None:
        """A fresh run owns its namespace: stale segments from an
        abandoned search must never splice into this run's traces.

        Multi-process safe: each process wipes ONLY its own shards' dirs
        (disjoint across processes), and the epoch writer additionally
        clears everything that belongs to no current shard (the old
        epochs.json, stale `shard<k>` dirs from an abandoned bigger
        layout) — so racing peers can never delete each other's (or the
        coordinator's) freshly written files."""
        import shutil

        live = {f"shard{d}" for d in range(self.D)}
        mine = {f"shard{d}" for d in self.local}
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if name in live and name not in mine:
                continue  # another process's current shard dir
            if name in live or self.epoch_writer:
                try:
                    if os.path.isdir(p):
                        shutil.rmtree(p, ignore_errors=True)
                    else:
                        os.unlink(p)
                except OSError:
                    pass
        self.epochs = [[0, self.D]]
        self._write_epochs()

    def resume(self, depth: int) -> bool:
        """Same-layout resume at `depth`: drop epochs past the resume
        level (a crashed run's future) and require the covering layout to
        be ours.  False = no resolvable trace; the engine disables the
        log and falls back to trace-less violations."""
        self.epochs = self._load_epochs()
        if self.epochs is None:
            return False
        self.epochs = [e for e in self.epochs if e[0] <= depth]
        if not self.epochs or self._epoch_D(depth) != self.D:
            self.epochs = None
            return False
        self._write_epochs()
        return True

    def reshard(self, depth: int, per_shard_rows) -> bool:
        """Elastic-resume boundary rewrite: re-emit level `depth` in the
        new shard-major order (`per_shard_rows` = the engine's
        re-bucketed pending frontier), carrying each row's (parent, act)
        over from the old-layout segments.  Rows are unique within a
        level, so the byte-keyed index is a bijection; a missing or
        corrupt old segment disables the log instead of guessing."""
        self.epochs = self._load_epochs()
        if self.epochs is not None:
            self.epochs = [e for e in self.epochs if e[0] <= depth]
        old_D = self._epoch_D(depth) if self.epochs else None
        if old_D is None:
            self.epochs = None
            return False
        try:
            rows_o, parent_o, act_o = self._read_level(depth, old_D)
        except ParentLogCorrupt:
            self.epochs = None
            return False
        index = {
            rows_o[i].tobytes(): i for i in range(rows_o.shape[0])
        }
        per_shard_sel = []
        try:
            for rows_d in per_shard_rows:
                rows_d = np.ascontiguousarray(rows_d, np.uint32)
                per_shard_sel.append(
                    (rows_d,
                     np.asarray([index[r.tobytes()] for r in rows_d],
                                np.int64))
                )
        except KeyError:  # not the same level content: refuse to splice
            self.epochs = None
            return False
        for d, (rows_d, sel) in enumerate(per_shard_sel):
            if d in self.local:
                self._log(d).write_level(
                    depth, rows_d, parent_o[sel], act_o[sel]
                )
        self.epochs = [e for e in self.epochs if e[0] < depth]
        self.epochs.append([depth, len(per_shard_rows)])
        self._write_epochs()
        return True

    # --- write side -----------------------------------------------------
    def write_level(self, level: int, rows_list, parent_list, act_list) -> None:
        """One level, already split per (new-layout) shard; each locally
        hosted shard publishes its slice as a CRC-framed segment."""
        for d in range(len(rows_list)):
            if d in self.local:
                self._log(d).write_level(
                    level,
                    np.ascontiguousarray(rows_list[d], np.uint32),
                    np.ascontiguousarray(parent_list[d], np.int64),
                    np.ascontiguousarray(act_list[d], np.int32),
                )

    # --- read side ------------------------------------------------------
    def _read_level(self, level: int, D_l: int):
        rows, parents, acts = [], [], []
        for d in range(D_l):
            lv = _LevelView(
                os.path.join(self.dir, f"shard{d}", _level_name(level))
            )
            rows.append(np.asarray(lv.rows))
            parents.append(np.asarray(lv.parent))
            acts.append(np.asarray(lv.act))
        return (
            np.concatenate(rows) if rows else np.empty((0, self.K), np.uint32),
            np.concatenate(parents) if parents else np.empty(0, np.int64),
            np.concatenate(acts) if acts else np.empty(0, np.int32),
        )

    def has_levels(self, upto: int) -> bool:
        if self.epochs is None:
            return False
        for level in range(upto + 1):
            D_l = self._epoch_D(level)
            if not D_l:
                return False
            for d in range(D_l):
                if not os.path.exists(
                    os.path.join(self.dir, f"shard{d}", _level_name(level))
                ):
                    return False
        return True

    def view(self) -> "ShardedParentLog._View":
        return ShardedParentLog._View(self)

    class _View:
        """Indexable like the in-RAM trace store: view[d] -> the level-d
        (rows, parent, act) triple, concatenated shard-major through the
        layout epoch that wrote it."""

        def __init__(self, log: "ShardedParentLog"):
            self.log = log

        def __getitem__(self, level: int):
            return self.log._read_level(level, self.log._epoch_D(level))
