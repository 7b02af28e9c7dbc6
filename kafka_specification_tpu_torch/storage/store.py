"""DiskTierStore: the single-device engine's composition of the disk tier.

The port's own copy of ``kafka_specification_tpu/storage/store.py``.  One
object owns the spill directory and the three disk structures — tiered
fingerprint set (`fps/`), spilled frontier segments (`frontier/`), parent
log (`plog/`) — plus the deletion barrier that ties file lifetime to
checkpoint generations.  The engine talks to this object only:

    disk = DiskTierStore(spill_dir, mem_budget, lanes=K, ...)
    disk.start_fresh(init_packed, init_fps)        # or disk.resume(...)
    per level:
        disk.begin_level(next_depth)
        per chunk: disk.append(novel_rows, parents, acts)
        reader = disk.end_level()                  # the next frontier
    checkpoint: manifest = disk.manifest(); ... disk.on_checkpoint_saved()

The checkpoint stores `json.dumps(disk.manifest())` + the (budget-bounded,
hence small) hot fingerprint dump — never the runs, segments, or log: the
disk tier IS the durable state; the checkpoint records how to reference it
(run names/CRCs, frontier segment offsets, parent-log depth).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .atomic import sweep_tmp
from .frontier import FrontierReader, FrontierWriter
from .parent_log import ParentLog
from .tiered import TieredFpSet


class DiskTierStore:
    def __init__(
        self,
        spill_dir: str,
        mem_budget: int,
        *,
        lanes: int,
        gc_barrier: int = 0,
        seg_rows: int = 1 << 18,
        runs_per_merge: int = 8,
        fault_plan=None,
        trace: bool = True,
        merge_worker=None,
    ):
        # normalized for the same reason as TieredFpSet.dir: resume's
        # orphan sweep compares dirnames textually against deleter paths
        self.dir = os.path.normpath(spill_dir)
        spill_dir = self.dir
        self.K = int(lanes)
        self.seg_rows = seg_rows
        os.makedirs(spill_dir, exist_ok=True)
        self.fpset = TieredFpSet(
            os.path.join(spill_dir, "fps"),
            mem_budget,
            runs_per_merge=runs_per_merge,
            gc_barrier=gc_barrier,
            fault_plan=fault_plan,
            merge_worker=merge_worker,
        )
        self.frontier_dir = os.path.join(spill_dir, "frontier")
        sweep_tmp(self.frontier_dir)  # mid-write death janitor
        self.plog = (
            ParentLog(
                os.path.join(spill_dir, "plog"), lanes, fault_plan=fault_plan
            )
            if trace
            else None
        )
        self._writer: Optional[FrontierWriter] = None
        self._reader: Optional[FrontierReader] = None
        # consumed frontier levels ride the same deletion barrier as
        # merged-away runs (older checkpoint generations reference them)
        self._deleter = self.fpset.deleter

    # --- lifecycle ------------------------------------------------------
    def start_fresh(self, init_packed: np.ndarray, init_fps: np.ndarray) -> None:
        for sub in (self.frontier_dir, os.path.join(self.dir, "plog")):
            if os.path.isdir(sub):
                for name in os.listdir(sub):
                    try:
                        os.unlink(os.path.join(sub, name))
                    except OSError:
                        pass
        self.fpset.start_fresh()
        self.fpset.insert(np.asarray(init_fps, np.uint64))
        w = FrontierWriter(self.frontier_dir, 0, self.K, self.seg_rows)
        w.append(init_packed)
        self._reader = w.finalize()
        if self.plog is not None:
            n0 = init_packed.shape[0]
            self.plog.write_level(
                0, init_packed, np.full(n0, -1, np.int64), np.full(n0, -1, np.int32)
            )

    def resume(self, manifest: dict, hot_fps: np.ndarray) -> None:
        """Rebuild from a checkpoint manifest: reopen the referenced runs
        and the pending frontier's segments (CRC-verified), re-seed the
        hot set.  Post-checkpoint orphans are swept; stale parent-log
        segments past the resume depth are left in place — the
        deterministic re-run overwrites them with identical bytes."""
        self.fpset.restore(manifest["fpset"], hot_fps)
        self._reader = FrontierReader(
            self.frontier_dir, manifest["frontier"], verify=True
        )
        # sweep frontier segments no generation references
        keep = {s["name"] for s in manifest["frontier"]["segments"]}
        keep |= {
            os.path.basename(p)
            for p in (x[1] for x in self._deleter.pending)
            if os.path.dirname(p) == self.frontier_dir
        }
        if os.path.isdir(self.frontier_dir):
            for name in os.listdir(self.frontier_dir):
                if name not in keep:
                    try:
                        os.unlink(os.path.join(self.frontier_dir, name))
                    except OSError:
                        pass

    def manifest(self) -> dict:
        assert self._reader is not None
        return {
            "fpset": self.fpset.manifest(),
            "frontier": self._reader.man,
        }

    def on_checkpoint_saved(self) -> None:
        self.fpset.on_checkpoint_saved()

    def poll_async(self) -> None:
        """Engine-thread adoption/error point for the background merge
        worker (no-op without one): finished merges swap in, worker
        errors — typed faults included — re-raise here."""
        self.fpset.poll_merge()

    def quiesce(self) -> None:
        """Wait out (and adopt) any in-flight background merge."""
        self.fpset.quiesce()

    def reclaim_merge(self) -> bool:
        """Soft-breach reclamation step: eagerly k-way merge all runs
        (superseded inputs go behind the deletion barrier; the caller's
        fresh checkpoint + generation prune then makes them deletable).
        Quiesces the merge worker first — a reclaim must never race a
        background promote.  Returns whether a merge ran — the caller
        skips its fresh checkpoint when nothing changed the on-disk
        state."""
        self.fpset.quiesce()
        if len(self.fpset.runs) < 2:
            return False
        self.fpset.merge()
        return True

    def flush_deleted(self) -> int:
        """Delete every barrier-pending file now — legal only right after
        the caller pruned all generations but the newest (see
        DeferredDeleter.flush).  Quiesces the merge worker first: an
        in-flight merge's inputs must reach the barrier (adoption) before
        a flush can claim the barrier is fully accounted.  Returns the
        number of files freed."""
        self.fpset.quiesce()
        return self._deleter.flush()

    def sweep_tmp(self) -> list:
        """Janitor pass over every directory this store writes.  Quiesces
        the merge worker first — the background merge's half-written tmp
        is live work, not a stray."""
        self.fpset.quiesce()
        out = sweep_tmp(os.path.join(self.dir, "fps"))
        out += sweep_tmp(self.frontier_dir)
        out += sweep_tmp(os.path.join(self.dir, "plog"))
        return out

    # --- per-level flow -------------------------------------------------
    def pending(self) -> FrontierReader:
        """The frontier the next level expands (discovery order)."""
        assert self._reader is not None
        return self._reader

    def begin_level(self, next_level: int) -> None:
        self._writer = FrontierWriter(
            self.frontier_dir, next_level, self.K, self.seg_rows
        )
        if self.plog is not None:
            self.plog.begin_level(next_level)

    def append(self, rows, parent, act) -> None:
        self._writer.append(rows)
        if self.plog is not None:
            self.plog.append(rows, parent, act)

    def end_level(self) -> FrontierReader:
        """Publish the level: the consumed frontier's segments go behind
        the deletion barrier, the new level becomes pending."""
        consumed = self._reader
        self._reader = self._writer.finalize()
        self._writer = None
        if self.plog is not None:
            self.plog.end_level()
        if consumed is not None:
            self._deleter.schedule(consumed.paths())
        return self._reader

    def abort_level(self) -> None:
        """A verdict cut the level short: drop the partial writer (its
        already-cut segments are harmless orphans, swept on next resume)."""
        self._writer = None

    def has_trace(self, depth: int) -> bool:
        return self.plog is not None and self.plog.has_levels(depth)

    def stats(self) -> dict:
        s = self.fpset.stats()
        if self._reader is not None:
            s["frontier_rows"] = self._reader.rows
            s["frontier_segments"] = len(self._reader.man["segments"])
        return s
