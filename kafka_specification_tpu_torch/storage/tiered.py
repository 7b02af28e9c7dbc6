"""TieredFpSet: host FpSet bounded by a byte budget, spilling to disk runs.

The port's own copy of ``kafka_specification_tpu/storage/tiered.py``
(the run files, bloom sidecars and manifest are the same byte for byte).
The host tier is the port's native C++ open-addressing FpSet
(``native/``); this class bounds its residency at `mem_budget` bytes.
When the hot set outgrows the budget, its fingerprints are dumped,
sorted, and written as one immutable on-disk run (storage/runs), and the
hot set restarts empty.  Membership is: hot set first, then each run's
bloom + interval gate, with a binary search over the run's mmap only on a
probable hit.  Because a fingerprint is inserted exactly once ever (the
novelty decision happens before any spill), runs are pairwise disjoint and
the hot set never overlaps disk — so the tiered set's novelty masks are
bit-identical to one unbounded FpSet's.

When the run count passes `runs_per_merge`, all runs k-way-merge into one
(fewer bloom probes per lookup, one searchsorted instead of k).  Merged
inputs are not deleted until `gc_barrier` newer checkpoint generations
have been saved (`on_checkpoint_saved`), so every retained generation's
manifest still resolves on disk — the deletion barrier is what makes the
disk tier itself the durable state the checkpoint merely *references*.

With a `merge_worker` (the overlap layer's ``kspec-io`` AsyncWorker,
``overlap.py``) the k-way merges run in the background: the worker only
writes files (tmp-write + atomic promote, the in-line merge's crash
contract), and lookups keep serving from the immutable input runs until
the engine thread *adopts* the merged run (`poll_merge`): the run list,
the gate counters and the deletion barrier change on the engine thread
only.  Without one (``--overlap off``) merges run in line on the caller's
thread, as the JAX package's serial path does, writing the same files.
Where thread timing decides when a merge is adopted, the run files may
differ from the serial path's, never the set's membership.
"""

from __future__ import annotations

import os

import numpy as np

from .. import durable_io as _dio
from ..native import FpSet
from ..resilience.faults import corrupt_file
from .atomic import sweep_tmp
from .runs import SortedRun, merge_runs, write_run

# ~bytes of host residency per fingerprint: 8 B/slot at <=1/2 open-
# addressing load, i.e. ~16 B per live entry
_BYTES_PER_FP = 16

#: machine-readable ownership contract (analysis/ownership.py), equal to
#: the JAX package's: the merge worker writes FILES ONLY — its job closure
#: captures immutable SortedRun inputs and never touches the set object,
#: so every attribute is engine-thread-only; adoption of a finished merge
#: (run-list swap, counter retirement, deletion-barrier scheduling)
#: happens on the engine thread in poll_merge.
THREAD_CONTRACT = {
    "schema": "kspec-ownership/1",
    "classes": {
        "DeferredDeleter": {
            "engine_only": ["pending", "barrier"],
        },
        "TieredFpSet": {
            "engine_only": ["hot", "runs", "disk_n", "seq", "spills",
                            "merges", "_merge_job", "_retired_probes",
                            "mem_budget", "deleter"],
            "immutable_after_init": ["dir", "runs_per_merge",
                                     "fault_plan", "verify_on_open",
                                     "merge_worker"],
        },
    },
}


class DeferredDeleter:
    """Deletion barrier keyed to checkpoint saves.

    `schedule(paths)` marks files obsolete; they are unlinked only after
    `barrier` subsequent `on_save()` calls (checkpoint generations), so no
    retained generation can reference a vanished file.  barrier=0 (not
    checkpointing) deletes immediately.  State round-trips through the
    checkpoint manifest so a resumed run keeps honoring in-flight barriers.
    """

    def __init__(self, barrier: int):
        self.barrier = max(0, int(barrier))
        self.pending: list = []  # [remaining_saves, path]

    def schedule(self, paths) -> None:
        if self.barrier == 0:
            for p in paths:
                _unlink_quiet(p)
            return
        self.pending.extend([self.barrier, p] for p in paths)

    def mark(self) -> int:
        """Watermark for :meth:`on_save` — the count of currently pending
        entries.  An ASYNC checkpoint save snapshots its manifest now but
        promotes later; its barrier advance must cover exactly the files
        scheduled before the snapshot (entries appended afterwards belong
        to younger state the write never referenced)."""
        return len(self.pending)

    def on_save(self, upto=None) -> None:
        """Advance the barrier for one durably promoted generation.
        `upto` (a :meth:`mark` watermark) restricts the advance to the
        entries pending at that save's snapshot; None = all (the
        synchronous path, where snapshot and promote coincide)."""
        n = len(self.pending) if upto is None else min(int(upto), len(self.pending))
        keep = []
        for i, item in enumerate(self.pending):
            if i < n:
                item[0] -= 1
            if item[0] <= 0:
                _unlink_quiet(item[1])
            else:
                keep.append(item)
        self.pending = keep

    def flush(self) -> int:
        """Delete every pending file NOW.  Legal only when the caller has
        just pruned all checkpoint generations older than the newest one
        (resource reclamation): the files' barrier counts protected
        exactly those generations' manifests."""
        n = len(self.pending)
        for _, p in self.pending:
            _unlink_quiet(p)
        self.pending = []
        return n

    def manifest(self, directory: str) -> list:
        return [[n, os.path.relpath(p, directory)] for n, p in self.pending]

    def restore(self, directory: str, entries) -> None:
        # normpath: entries may point outside `directory` (the engine
        # store routes frontier-segment deletions through the same
        # barrier, serialized as "../frontier/..." relpaths) and sweep
        # code compares dirnames textually
        self.pending = [
            [int(n), os.path.normpath(os.path.join(directory, p))]
            for n, p in entries
        ]


def _unlink_quiet(path: str) -> None:
    for p in (path, path + ".bloom"):
        try:
            _dio.unlink(p)
        except OSError:
            pass


class TieredFpSet:
    """Budget-bounded host FpSet + immutable sorted disk runs.

    The engine's visited set when the disk tier is on (`insert(u64) ->
    novelty mask`, `insert_level`, `contains`, `len`)."""

    def __init__(
        self,
        directory: str,
        mem_budget: int,
        *,
        runs_per_merge: int = 8,
        gc_barrier: int = 0,
        fault_plan=None,
        verify_on_open: bool = True,
        merge_worker=None,
    ):
        """merge_worker: an :class:`~..overlap.AsyncWorker` — k-way merges
        then run in the background.  The worker only writes files
        (tmp-write + atomic promote, the in-line merge's crash contract);
        the run list, gate counters and the deletion barrier mutate ONLY
        on the engine thread when a finished merge is *adopted*
        (poll_merge), so lookups keep serving from the immutable inputs
        the whole time and never block on an unfinished merge.  Worker
        errors — including the injected crash@merge:N / enospc@merge:N
        faults, which fire on the worker — re-raise on the engine thread
        at the next poll/quiesce."""
        # normalized: orphan sweeps and the deletion barrier compare paths
        # textually, and DeferredDeleter.restore normpaths its entries —
        # a dot-prefixed directory ("./ck/spill") must compare equal
        self.dir = os.path.normpath(directory)
        self.mem_budget = int(mem_budget)
        self.runs_per_merge = max(2, int(runs_per_merge))
        self.fault_plan = fault_plan
        self.verify_on_open = verify_on_open
        self.deleter = DeferredDeleter(gc_barrier)
        self.merge_worker = merge_worker
        self._merge_job = None  # (job, inputs, out_path) in flight
        self.hot = FpSet()  # builds native/fpset.cpp at first use; raises without g++
        self.runs: list[SortedRun] = []
        self.disk_n = 0
        self.seq = 0  # next run file number (monotonic across merges)
        self.spills = 0
        self.merges = 0
        # bloom-gate traffic accumulated on merged-away runs (their
        # per-run counters die with them; totals must not)
        self._retired_probes = {"probes": 0, "bloom_maybe": 0, "hits": 0}
        os.makedirs(directory, exist_ok=True)
        # startup janitor: a mid-write death leaves a .tmp sibling no
        # manifest references; sweep it before it masquerades as usage
        sweep_tmp(self.dir)

    # --- lifecycle ------------------------------------------------------
    def start_fresh(self) -> None:
        """Wipe the directory (a fresh run owns its namespace — stale runs
        from an abandoned search must not pre-seed the visited set)."""
        self._abandon_merge()
        for name in os.listdir(self.dir):
            _unlink_quiet(os.path.join(self.dir, name))
        self.hot = FpSet()
        self.runs = []
        self.disk_n = 0
        self.seq = 0

    def restore(self, manifest: dict, hot_fps) -> None:
        """Restore this set IN PLACE from a checkpoint manifest: reopen
        (and verify) exactly the referenced runs, re-seed the hot set from
        the checkpointed dump, and sweep orphan files (tmp/run files from
        the crashed post-checkpoint window — the deterministic re-run
        regenerates them identically)."""
        self._abandon_merge()
        directory = self.dir
        self.mem_budget = int(manifest["mem_budget"])
        self.seq = int(manifest["seq"])
        self.spills = int(manifest.get("spills", 0))
        self.merges = int(manifest.get("merges", 0))
        self.runs = [
            SortedRun(directory, m, verify=self.verify_on_open)
            for m in manifest["runs"]
        ]
        self.disk_n = sum(r.count for r in self.runs)
        self.deleter.restore(directory, manifest.get("pending_delete", ()))
        keep = {os.path.join(directory, m["name"]) for m in manifest["runs"]}
        keep |= {p for _, p in self.deleter.pending}
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if p not in keep and not p.endswith(".bloom"):
                _unlink_quiet(p)
            elif p.endswith(".bloom") and p[: -len(".bloom")] not in keep:
                _unlink_quiet(p)
        self.hot = FpSet()
        if hot_fps is not None and len(hot_fps):
            self.hot.insert(np.asarray(hot_fps, np.uint64))

    @classmethod
    def from_manifest(cls, directory: str, manifest: dict, hot_fps,
                      **kwargs) -> "TieredFpSet":
        s = cls(directory, manifest["mem_budget"], **kwargs)
        s.restore(manifest, hot_fps)
        return s

    def manifest(self) -> dict:
        return {
            "mem_budget": self.mem_budget,
            "seq": self.seq,
            "spills": self.spills,
            "merges": self.merges,
            "runs": [r.meta for r in self.runs],
            "pending_delete": self.deleter.manifest(self.dir),
        }

    def on_checkpoint_saved(self) -> None:
        self.deleter.on_save()

    # --- set interface --------------------------------------------------
    def _disk_contains(self, fps: np.ndarray) -> np.ndarray:
        out = np.zeros(fps.shape[0], bool)
        rem = np.arange(fps.shape[0])
        for r in self.runs:
            if rem.size == 0:
                break
            hit = r.contains(fps[rem])
            out[rem[hit]] = True
            rem = rem[~hit]
        return out

    def insert(self, fps: np.ndarray) -> np.ndarray:
        """Novelty mask, bit-identical to an unbounded FpSet (in-batch
        duplicates report novel exactly once, at first occurrence)."""
        if self._merge_job is not None:
            self.poll_merge()  # adopt a finished background merge (and
            # surface its errors) before probing the run list
        fps = np.ascontiguousarray(fps, np.uint64)
        novel = np.zeros(fps.shape[0], bool)
        fresh = ~self._disk_contains(fps)
        if fresh.any():
            idx = np.nonzero(fresh)[0]
            novel[idx] = self.hot.insert(fps[idx])
            self._maybe_spill()
        return novel

    def insert_level(self, fps: np.ndarray,
                     slice_rows: int = 1 << 18) -> np.ndarray:
        """Once-per-level batched insert (the device pipeline's deferred
        probe): the same novelty mask as :meth:`insert` over per-chunk
        calls, shaped for ONE call per BFS level.

        The disk probe runs over the SORTED query batch, once per run per
        level (sorted queries walk each run's mmap monotonically); the
        hot-tier insert still runs in budget-bounded slices with the spill
        check between them, so residency stays bounded at ``mem_budget +
        slice_rows*16`` bytes like the per-chunk path's.

        The caller's batch is duplicate-free within the level (the device
        level-new set guarantees it), so slice order cannot change any
        first-occurrence decision; runs stay pairwise disjoint because the
        disk probe still precedes every hot insert."""
        if self._merge_job is not None:
            self.poll_merge()
        fps = np.ascontiguousarray(fps, np.uint64)
        novel = np.zeros(fps.shape[0], bool)
        if not fps.shape[0]:
            return novel
        order = np.argsort(fps, kind="stable")
        fresh_sorted = ~self._disk_contains(fps[order])
        fresh = np.zeros_like(fresh_sorted)
        fresh[order] = fresh_sorted
        idx = np.nonzero(fresh)[0]
        # hot membership must be resolved BEFORE the sliced inserts: a
        # mid-call spill moves the pre-call hot set to disk, so a later
        # slice's hot.insert would wrongly re-admit a fingerprint the
        # level started with in the hot tier
        if idx.shape[0]:
            idx = idx[~self.hot.contains(fps[idx])]
        novel[idx] = True
        for at in range(0, idx.shape[0], slice_rows):
            sl = idx[at: at + slice_rows]
            self.hot.insert(fps[sl])
            self._maybe_spill()
        return novel

    def contains(self, fps: np.ndarray) -> np.ndarray:
        fps = np.ascontiguousarray(fps, np.uint64)
        out = self.hot.contains(fps)
        miss = ~out
        if miss.any():
            idx = np.nonzero(miss)[0]
            out[idx] = self._disk_contains(fps[idx])
        return out

    def __len__(self) -> int:
        return self.disk_n + len(self.hot)

    def hot_dump(self) -> np.ndarray:
        return self.hot.dump()

    def dump(self) -> np.ndarray:
        """Every fingerprint, hot + disk (tests / tiny sets only)."""
        for r in self.runs:  # read-side CRC: dumps verify like lookups
            if not r._read_verified:
                r._verify_content()
        parts = [self.hot.dump()] + [np.asarray(r.arr) for r in self.runs]
        return np.concatenate(parts) if parts else np.empty(0, np.uint64)

    def stats(self) -> dict:
        return {
            "hot": len(self.hot),
            "disk": self.disk_n,
            "runs": len(self.runs),
            "spills": self.spills,
            "merges": self.merges,
            "disk_bytes": 8 * self.disk_n,
            # bloom-gate accounting per open run (how much disk traffic
            # the per-run gates save — bloom_filtered probes never touched
            # the mmap)
            "run_probes": [
                {
                    "name": r.meta["name"],
                    "probes": r.probes,
                    "bloom_maybe": r.bloom_maybe,
                    "bloom_filtered": r.probes - r.bloom_maybe,
                    "hits": r.hits,
                }
                for r in self.runs
            ],
            # whole-run totals: live runs + everything merged away
            "bloom_totals": {
                k: self._retired_probes[k]
                + sum(getattr(r, a) for r in self.runs)
                for k, a in (
                    ("probes", "probes"),
                    ("bloom_maybe", "bloom_maybe"),
                    ("hits", "hits"),
                )
            },
        }

    # --- spill / merge --------------------------------------------------
    def _hot_bytes(self) -> int:
        return _BYTES_PER_FP * len(self.hot)

    def _maybe_spill(self) -> None:
        if self._hot_bytes() > self.mem_budget:
            self.spill()

    def _run_path(self) -> str:
        path = os.path.join(self.dir, f"run-{self.seq:06d}.fps")
        self.seq += 1
        return path

    def spill(self) -> None:
        """Dump + sort the hot set into a new immutable run; restart the
        hot set empty.  Triggers a k-way merge past `runs_per_merge`."""
        fps = np.sort(self.hot.dump())
        if fps.shape[0] == 0:
            return
        # lazy import: obs <-> storage must stay acyclic at module level
        from ..obs import metrics as _met
        from ..obs import tracer as _obs

        path = self._run_path()
        hook = None
        if self.fault_plan is not None:
            ordinal = self.spills + 1

            def hook():
                # full-disk rehearsal (enospc@spill:N): fires after the
                # tmp write, before the promote — atomic_write cleans up
                # the tmp and the hot set is untouched (it restarts empty
                # only after a successful promote), so the RESOURCE_EXHAUSTED
                # exit leaves a verifiable state
                self.fault_plan.enospc("spill", ordinal)

        with _obs.span("spill-run-write", rows=int(fps.shape[0])):
            meta = write_run(path, fps, bloom_path=path + ".bloom", before_replace=hook)
        _met.inc("kspec_spill_runs_total")
        if self.fault_plan is not None and self.fault_plan.flip(
            "spill", self.spills + 1
        ):
            # silent on-disk corruption AFTER the atomic promote (the
            # window atomic writes cannot close): caught by the run's
            # read-side CRC on its first lookup (SortedRun.contains),
            # typed INTEGRITY_VIOLATION by the engine
            corrupt_file(path)
        self.runs.append(SortedRun(self.dir, meta, verify=False))
        self.disk_n += fps.shape[0]
        self.spills += 1
        self.hot = FpSet()
        if len(self.runs) > self.runs_per_merge:
            if self.merge_worker is not None:
                self._start_merge()
            else:
                self.merge()

    def merge(self) -> None:
        """K-way merge every run into one.  Crash-safe: the merged output
        is tmp-written then atomically promoted; the inputs stay on disk
        behind the checkpoint-generation deletion barrier, so a crash at
        ANY point (including the injected `crash@merge:N`) leaves a state
        some retained checkpoint manifest fully resolves."""
        self.quiesce()  # a reclaim's eager merge must not race a
        # background promote over the same inputs
        if len(self.runs) < 2:
            return
        from ..obs import metrics as _met
        from ..obs import tracer as _obs

        self.merges += 1
        path = self._run_path()
        hook = None
        if self.fault_plan is not None:
            ordinal = self.merges

            def hook():
                self.fault_plan.crash("merge", ordinal)
                self.fault_plan.enospc("merge", ordinal)

        with _obs.span(
            "spill-merge",
            runs=len(self.runs),
            rows=int(sum(r.count for r in self.runs)),
        ):
            meta = merge_runs(self.runs, path, crash_hook=hook)
        _met.inc("kspec_spill_merges_total")
        for r in self.runs:  # retire the merged-away runs' gate counters
            self._retired_probes["probes"] += r.probes
            self._retired_probes["bloom_maybe"] += r.bloom_maybe
            self._retired_probes["hits"] += r.hits
        old = [r.path for r in self.runs]
        self.runs = [SortedRun(self.dir, meta, verify=False)]
        self.deleter.schedule(old)

    # --- background merges (KSPEC_OVERLAP) -------------------------------
    def _start_merge(self) -> None:
        """Submit a k-way merge of the CURRENT runs to the worker.  At
        most one merge is in flight; if one still is, this spill's runs
        simply ride along until the next trigger (the run list only
        grows between merges, so correctness never depends on merge
        timing — only lookup fan-out does)."""
        self.poll_merge()
        if self._merge_job is not None:
            return  # one merge at a time; adopted at the next poll
        inputs = list(self.runs)
        if len(inputs) < 2:
            return
        self.merges += 1
        ordinal = self.merges
        path = self._run_path()
        fault_plan = self.fault_plan

        def job():
            # worker-side: files only.  The crash/enospc injection points
            # fire HERE (on the worker) and propagate to the engine
            # thread at its next poll/quiesce — same typed exits, same
            # on-disk contract (tmp cleaned, inputs untouched).
            from ..obs import metrics as _met
            from ..obs import tracer as _obs

            hook = None
            if fault_plan is not None:
                def hook():
                    fault_plan.crash("merge", ordinal)
                    fault_plan.enospc("merge", ordinal)

            with _obs.span(
                "spill-merge",
                runs=len(inputs),
                rows=int(sum(r.count for r in inputs)),
                background=True,
            ):
                meta = merge_runs(inputs, path, crash_hook=hook)
            _met.inc("kspec_spill_merges_total")
            return meta

        self._merge_job = (
            self.merge_worker.submit("spill-merge", job), inputs, path
        )

    def poll_merge(self, wait: bool = False) -> None:
        """Engine-thread adoption point: if the in-flight merge finished,
        swap the merged run in for its inputs (newer spills appended
        after submission stay), retire the inputs' gate counters, and
        schedule the input files on the deletion barrier.  Re-raises the
        worker's stored error (typed faults included)."""
        if self._merge_job is None:
            return
        job, inputs, path = self._merge_job
        if not wait and not job.done.is_set():
            return
        try:
            # wait() re-raises THIS job's error (consuming it from the
            # worker's failed queue) — with several tiered sets sharing
            # one worker, a sibling's poll must never launder our error
            # (or vice versa) into the wrong adoption
            meta = self.merge_worker.wait(job)
        except BaseException:
            self._merge_job = None
            raise
        self._merge_job = None
        for r in inputs:
            self._retired_probes["probes"] += r.probes
            self._retired_probes["bloom_maybe"] += r.bloom_maybe
            self._retired_probes["hits"] += r.hits
        self.runs = [SortedRun(self.dir, meta, verify=False)] + [
            r for r in self.runs if r not in inputs
        ]
        self.deleter.schedule([r.path for r in inputs])

    def quiesce(self) -> None:
        """Block until no merge is in flight and adopt its output —
        REQUIRED before any reclamation that sweeps tmp files, flushes
        the deletion barrier, or runs an in-line merge (a reclaim racing
        a background promote could unlink the merge's tmp mid-write or
        flush files its manifest still needs)."""
        if self._merge_job is not None:
            self.poll_merge(wait=True)

    def _abandon_merge(self) -> None:
        """Wait out (never adopt) an in-flight merge — fresh-start /
        restore paths: the merged output becomes an unreferenced orphan
        their sweeps remove.  Worker errors are swallowed (the state the
        merge would have produced is being discarded anyway)."""
        if self._merge_job is None:
            return
        job, _inputs, _path = self._merge_job
        self._merge_job = None
        try:
            self.merge_worker.wait(job)  # consumes THIS job's error only
        except BaseException:  # noqa: BLE001 — discarded with the merge
            pass


# KSPEC_TSAN=1 (test-only): assert THREAD_CONTRACT ownership on every
# attribute write (analysis/ownership.py); no cost otherwise
from ..analysis.ownership import bind_contract as _bind_contract  # noqa: E402

_bind_contract(globals(), THREAD_CONTRACT)
