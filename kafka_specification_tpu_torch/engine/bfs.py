"""Single-device level-synchronous BFS model checker (PyTorch).

Counterpart of ``kafka_specification_tpu/engine/bfs.py::check``, with its
defaults: the sorted ``device`` visited set, the ``fused`` pipeline (or
``$KSPEC_PIPELINE``), ``compact_shift=2``, ``compact_gate=4096``.  Per
chunk of the frontier (``engine/pipeline.py``): invariants on the chunk,
every action kernel on every (state, choice) cell, the enabled candidates
packed in candidate order, their fingerprints (kernel K1), then the
visited backend:

- ``device``: the sorted set of fingerprint order keys.  The stable sort
  keeps the first copy of each fingerprint in candidate order; the new
  states are committed in FINGERPRINT order and merged into the set by
  rank (``pipeline.sorted_dedup_stage``, ``ops/dedup.py``).
- ``device-hash``: the open-addressing table (kernel K2).  The lowest-index
  copy of each fingerprint not yet visited is new; the new states are
  committed in CANDIDATE order.
- ``host``: the native C++ fingerprint set (``native/``).  The chunk's
  fingerprints come to the host, the set inserts them in candidate order
  and the first copy of each unseen one is new; the new states, which stay
  on the device, are committed in CANDIDATE order.

So the backends reach the same states level by level, in other orders,
and may report other traces; each gives the JAX package's result for the
same knobs: the same level counts, level rows in the same order, the same
first violation and trace, the same per-level stats records and the same
digest chain.  The JAX package's rules are followed: inits deduped as
``np.unique(axis=0)``; a chunk is ``next_pow2(max(min_bucket,
chunk_size))`` frontier rows, padded in the JAX package to the bucket
``next_pow2(max(rows, min_bucket))`` that selects the candidate order; the
sorted set starts at ``next_pow2(max(n0, min_bucket * C, 2))`` entries (or
as ``visited_capacity_hint``/``_exact`` say) and grows to the next power of
two before any chunk with ``n + bucket * C`` over its capacity; the table
starts from ``table_from_pairs`` with at least ``_HASH_MIN_CAP`` slots and
doubles before any chunk that finds it over half full, and a probe
overflow doubles it and re-runs the same batch, OR-ing novelty; the first
violation is the first invariant in model order at the first row of the
first chunk, then a deadlock; a run cut by ``max_depth`` or ``max_states``
(at the first level boundary with ``total >= max_states``) checks the
invariants of the frontier it did not expand.

The level digest chain (``resilience/integrity.py``; off with
``KSPEC_INTEGRITY=0``) folds each chunk's new fingerprints and seals each
level; the frontier about to be expanded is fingerprinted again (K1) and
held against its sealed entry.  Checkpoints (``checkpoint_dir``) are the
JAX package's files, name for name and dtype for dtype, so either package
resumes the other's.  Everything but the host set's probe stays on
``device``; the host reads counts, flags, the chain's fingerprints and the
violation's index.

The disk tier (``mem_budget``/``store="disk"``, ``storage/``) takes the
host set past RAM: the set spills sorted runs to disk, each level's new
states stream to spilled frontier segments and to an on-disk parent log
(their rows come back to the host), and the next level reads its frontier
back a chunk at a time onto the card, so no tensor holds a spilled level
(a device-resident level stages it whole, as the JAX package does).  The
resource governor (``resilience/resources.py``) watches disk, memory and
time at every level boundary, and ``$KSPEC_FAULT`` (``resilience/
faults.py``) injects crashes, full disks, stalls and bit flips at the same
sites as the JAX engine.

The overlap layer (``overlap.py``; ``check(overlap=)``, ``$KSPEC_OVERLAP``,
default on, as in the JAX package) changes when work runs, never what it
computes: the per-chunk loop stages two chunks (chunk k+1 dispatched
before chunk k is committed; ``pipeline.run_chunk``), the disk tier's
merges run on the ``kspec-io`` worker and checkpoint writes on
``kspec-ckpt``.  Everything runs on one CUDA stream, and no worker thread
makes a CUDA call.  The sorted ``device`` set's dedup stays in the commit:
chunk k+1's dedup is queued after chunk k's merge, in stream order, so it
sees it, and the set grows on its size after that merge, as in the JAX
engine (whose dispatch holds the dedup).  The device-hash table grows
before a chunk's dispatch, as the JAX engine's does.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..analysis import require_encoding_sound
from ..interop import from_u32, to_u32
from ..models.base import Model
from ..native import FpSet
from ..obs import metrics as _met
from ..obs.observer import RunObserver
from ..ops import dedup, hashset
from ..ops.cuda_hashset import probe_insert
from ..overlap import AsyncWorker, close_workers, overlap_enabled, worker_counters
from ..pipeline_registry import resolve_pipeline
from ..resilience import integrity
from ..resilience.checkpoints import CheckpointStore
from ..resilience.faults import WIRED, FaultPlan, corrupt_file
from ..resilience.integrity import IntegrityError
from ..resilience.resources import ResourceExhausted, ResourceGovernor, is_disk_full
from ..storage import DEFAULT_MEM_BUDGET, DiskTierStore, parse_mem_budget, resolve_store
from ..storage.frontier import FrontierReader, SegmentCorrupt
from ..storage.parent_log import ParentLogCorrupt
from ..storage.runs import RunCorrupt
from .pipeline import (DevicePipeline, HostSlots, compacts, fp_stage, grow_visited, invariant_stage,
                       next_pow2, run_chunk, sorted_dedup_stage)

# device-hash table floor (module-level so tests can shrink it to exercise
# the growth and overflow-re-run paths at small state counts)
_HASH_MIN_CAP = 1 << 16
VISITED_BACKENDS = ("device", "device-hash", "host")
# what the JAX package reports as stats["visited_capacity"], and saves as a
# checkpoint's `vcap`, for the backends that keep no sorted set: the shape
# of its placeholder arrays
_NO_SORTED_CAP = 64
CHECKPOINT_BASENAME = "bfs_checkpoint.npz"


def resolve_device(device=None) -> torch.device:
    """None means the card.  The CPU runs only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the checker runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class Violation:
    invariant: str
    depth: int
    state: object  # decoded canonical state (or raw dict if no decoder)
    trace: list  # [(action_name | "<init>", decoded state), ...] root -> violation


@dataclass
class CheckResult:
    model: str
    levels: list[int]  # distinct new states per BFS level (level 0 = inits)
    total: int
    diameter: int
    violation: Optional[Violation]
    seconds: float
    states_per_sec: float
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.violation is None


def walk_trace(trace_store, actions, decode_row, inv_name, depth, idx) -> Violation:
    """Parent-pointer counterexample reconstruction.

    trace_store[level] = (rows, parent, act): the level's states in discovery
    order, each one's parent index into the previous level, and the action
    id that produced it.  Walks level `depth` index `idx` back to an init
    state and returns the Violation with the root -> violation trace.
    """
    chain = []
    i = idx
    for d in range(depth, 0, -1):
        rows, parent, act = trace_store[d]
        chain.append((actions[int(act[i])].name, decode_row(rows[i])))
        i = int(parent[i])
    rows0, _, _ = trace_store[0]
    chain.append(("<init>", decode_row(rows0[i])))
    chain.reverse()
    return Violation(invariant=inv_name, depth=depth, state=chain[-1][1], trace=chain)


def fps_u64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    """(hi, lo) u32 values in int64 tensors -> the uint64 fingerprints
    hi << 32 | lo, on the host."""
    return dedup.pair_key(hi, lo).cpu().numpy().view(np.uint64)


class _SortedVisited:
    """The ``device`` backend: sorted order keys, padded to a power of two."""

    host_keys = False  # a chunk's insert takes its fingerprints on the card

    def __init__(self, okeys: torch.Tensor, cap: int):
        """okeys: the set's order keys, ascending."""
        self.n = okeys.shape[0]
        self.keys = grow_visited(okeys, cap)

    @classmethod
    def fresh(cls, hi0, lo0, cap: int):
        return cls(torch.sort(dedup.order_key(hi0, lo0)).values, cap)

    @classmethod
    def resume(cls, snap: dict, dev):
        # JAX keeps the set as u32 (vhi, vlo) sorted by (hi, lo): their
        # order keys are ascending as they lie
        okeys = dedup.order_key(from_u32(snap["vhi"], dev), from_u32(snap["vlo"], dev))
        return cls(okeys, int(snap["vcap"]))

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    def reserve(self, width: int):
        """Room for a chunk of up to `width` new keys."""
        if self.n + width > self.keys.shape[0]:
            self.keys = grow_visited(self.keys, self.n + width)

    def insert(self, hi, lo) -> torch.Tensor:
        """-> candidate indices of the new states, in fingerprint order."""
        winners, self.keys, self.n = sorted_dedup_stage(dedup.order_key(hi, lo), self.keys, self.n)
        return winners

    def merge_level(self, okeys: torch.Tensor) -> None:
        """One rank merge of a device level's new keys (ascending, disjoint
        from the set): the set the level's per-chunk merges would give."""
        rank = dedup.rank_sorted(self.keys, self.n, okeys)[1]
        self.keys, self.n = dedup.merge_ranked(self.keys, self.n, okeys, rank, self.keys.shape[0])

    def save_arrays(self) -> dict:
        hi, lo = dedup.order_key_to_pair(self.keys[: self.n])
        return {"vhi": to_u32(hi), "vlo": to_u32(lo), "vn": self.n}

    def stats(self) -> dict:
        return {}


class _HashVisited:
    """The ``device-hash`` backend: the open-addressing table (kernel K2)."""

    capacity = _NO_SORTED_CAP
    host_keys = False

    def __init__(self, hi, lo, min_cap: int):
        self.table = hashset.table_from_pairs(hi, lo, min_cap=min_cap)
        self.n = hi.shape[0]

    @classmethod
    def resume(cls, snap: dict, dev):
        return cls(from_u32(snap["hash_hi"], dev), from_u32(snap["hash_lo"], dev), _HASH_MIN_CAP)

    def reserve(self, width: int):
        if 2 * self.n > self.table.shape[0]:
            # keep the load factor under 1/2 so probe chains stay short
            self.table = hashset.rehash_into(self.table, 2 * self.table.shape[0])

    def insert(self, hi, lo) -> torch.Tensor:
        """-> candidate indices of the new states, in candidate order."""
        keys = dedup.pair_key(hi, lo)
        isnew = None
        while True:
            # n and ovf come to the host in one read
            self.table, is_new, n, ovf = probe_insert(self.table, keys)
            isnew = is_new if isnew is None else isnew | is_new
            self.n += n
            if not ovf:
                break
            # rows the failed attempt inserted (and counted) report "seen"
            # on the re-run; OR-ing keeps them new, so nothing is lost or
            # counted twice
            self.table = hashset.rehash_into(self.table, 2 * self.table.shape[0])
        return isnew.nonzero().squeeze(1)

    def save_arrays(self) -> dict:
        """The live slots, in slot order."""
        hi, lo = hashset.live_pairs(self.table)
        return {"hash_hi": to_u32(hi), "hash_lo": to_u32(lo)}

    def stats(self) -> dict:
        return {"hash_table_capacity": int(self.table.shape[0]), "hash_table_size": self.n}


class _HostVisited:
    """The ``host`` backend: the native fingerprint set (``native/``)."""

    capacity = _NO_SORTED_CAP
    host_keys = True  # a chunk's insert takes its fingerprints on the host

    def __init__(self, fps: np.ndarray, initial_capacity: int = 1 << 16):
        self.set = FpSet(initial_capacity)  # builds fpset.cpp at first use; raises without g++
        self.set.insert(fps)

    @classmethod
    def resume(cls, snap: dict, dev):
        fps = snap["host_fps"]
        return cls(fps, max(64, 2 * len(fps)))

    def reserve(self, width: int):
        pass  # the set grows itself

    def insert(self, keys: np.ndarray) -> np.ndarray:
        """A chunk's fingerprint pair keys (int64 bit patterns, in candidate
        order, on the host) -> indices of the new ones, in candidate
        order."""
        return np.flatnonzero(self.set.insert(keys.view(np.uint64)))

    def insert_keys(self, keys: np.ndarray) -> np.ndarray:
        """A device level's one batched insert (the same keys and answer)."""
        return self.insert(keys)

    def save_arrays(self) -> dict:
        return {"host_fps": self.set.dump()}

    def stats(self) -> dict:
        return {"host_fpset_size": len(self.set)}


class _TierVisited(_HostVisited):
    """The disk tier's visited set (``storage/``): the host set bounded by
    `mem_budget` (``TieredFpSet``), spilling sorted runs to disk."""

    def __init__(self, disk):
        self.disk = disk
        self.set = disk.fpset

    @classmethod
    def fresh(cls, disk, init_packed, fps: np.ndarray):
        # a fresh out-of-core run owns the spill directory's namespace
        disk.start_fresh(to_u32(init_packed), fps)
        return cls(disk)

    @classmethod
    def resume(cls, snap: dict, disk):
        # the checkpoint references the tier, it does not contain it: reopen
        # the manifest's runs and frontier segments, re-seed the hot set
        disk.resume(json.loads(str(snap["spill_manifest"])), snap["host_fps"])
        return cls(disk)

    def insert_keys(self, keys: np.ndarray) -> np.ndarray:
        # a level's one batched insert, which spills between slices
        return np.flatnonzero(self.set.insert_level(keys.view(np.uint64)))

    def save_arrays(self) -> dict:
        """The tier IS the durable state: its manifest and the hot dump,
        never the runs, segments or log themselves."""
        return {"spill_manifest": json.dumps(self.disk.manifest()),
                "host_fps": self.set.hot_dump()}

    def stats(self) -> dict:
        return {"host_fpset_size": len(self.set), "spill": self.disk.stats(),
                "spill_dir": self.disk.dir, "mem_budget": self.set.mem_budget}


_RESUMES = {"device": _SortedVisited, "device-hash": _HashVisited, "host": _HostVisited}


class _RamFrontier:
    """A level held as one int64 tensor on the card."""

    def __init__(self, rows: torch.Tensor):
        self.t = rows

    @property
    def rows(self) -> int:
        return self.t.shape[0]

    def read_all(self) -> torch.Tensor:
        return self.t

    def row(self, i: int) -> torch.Tensor:
        return self.t[i]

    def chunks(self, chunk: int, start: int = 0):
        """-> (offset, rows) pieces of `chunk` rows from row `start` on."""
        return ((s, self.t[s : s + chunk]) for s in range(start, self.rows, chunk))

    def stage_refusal(self) -> Optional[str]:
        return None

    def flip(self) -> None:
        u32 = to_u32(self.t)
        integrity.flip_bit(u32)
        self.t = from_u32(u32, self.t.device)

    def verify(self, chain, depth: int, spec) -> None:
        # the frontier about to be expanded must digest to the entry sealed
        # when its level was found (or loaded from a checkpoint)
        integrity.count_check()
        if chain.anchored and depth < len(chain.entries):
            chain.verify_level(depth, fps_u64(*fp_stage(spec, self.t)))

    def save_arrays(self) -> dict:
        return {"frontier": to_u32(self.t)}


class _SpilledFrontier:
    """A level in spilled segments (``storage/frontier.py``), read onto the
    card a chunk at a time, so no tensor holds it (a device-resident level
    stages it whole, as the JAX package does)."""

    def __init__(self, reader, dev):
        self.reader = reader
        self.dev = dev

    @property
    def rows(self) -> int:
        return self.reader.rows

    def read_all(self) -> torch.Tensor:
        return from_u32(self.reader.read_all(), self.dev)

    def row(self, i: int) -> np.ndarray:
        return self.reader.row(i)

    def chunks(self, chunk: int, start: int = 0):
        return ((s, from_u32(p, self.dev)) for s, p in self.reader.iter_chunks(chunk) if s >= start)

    def stage_refusal(self) -> Optional[str]:
        """Why the level is too large to stage whole on the card, if it is."""
        mat_bytes = self.rows * self.reader.K * 4
        mat_budget = int(os.environ.get("KSPEC_DEVLEVEL_MAT_BUDGET", str(1 << 31)))
        if mat_bytes <= mat_budget:
            return None
        return (f"spilled frontier too large to materialize for the device span "
                f"({mat_bytes} B > KSPEC_DEVLEVEL_MAT_BUDGET {mat_budget} B)")

    def flip(self) -> None:
        # the flip lands in a segment file, whose read-side CRC catches it at
        # the level's first read
        if self.reader.paths():
            self.reader._read_verified.clear()
            corrupt_file(self.reader.paths()[0])

    def verify(self, chain, depth: int, spec) -> None:
        pass  # the segments' CRCs cover a spilled level; it is not fingerprinted again

    def save_arrays(self) -> dict:
        return {}  # the checkpoint references it through the tier's manifest


class _RamLevels:
    """Where each level's new states go in RAM: tensors on the card, and,
    with `keep_trace`, every level's rows, parents and actions for the
    trace walk."""

    def __init__(self, init_packed: torch.Tensor, keep_trace: bool):
        none = torch.full((init_packed.shape[0],), -1, dtype=torch.int64, device=init_packed.device)
        self.trace = [(init_packed, none, none)] if keep_trace else None
        self.empty = (init_packed[:0], none[:0], none[:0])
        self.parts = []

    def begin(self, depth: int) -> None:
        self.parts = []

    def append(self, rows, parent, act) -> None:
        self.parts.append((rows, parent, act))

    def append_kept(self, out, keep: np.ndarray, start: int) -> None:
        """A chunk's new states, `keep` its candidate indices on the host."""
        idx = torch.from_numpy(keep).to(out.rows.device)
        self.append(out.rows[idx], out.parent[idx] + start, out.act[idx])

    def end(self) -> _RamFrontier:
        level = tuple(torch.cat(x) for x in zip(*self.parts)) if self.parts else self.empty
        if self.trace is not None:
            self.trace.append(level)
        return _RamFrontier(level[0])

    def abort(self) -> None:
        pass

    def trace_view(self, depth: int):
        return self.trace


class _DiskLevels:
    """Where each level's new states go on the disk tier: the spilled
    frontier's segments and the on-disk parent log, in discovery order
    (int64 parents, level-global)."""

    def __init__(self, disk, dev):
        self.disk = disk
        self.dev = dev

    def begin(self, depth: int) -> None:
        self.disk.begin_level(depth)

    def append(self, rows, parent, act) -> None:
        self.disk.append(to_u32(rows), parent.cpu().numpy(), act.cpu().numpy())

    def append_kept(self, out, keep: np.ndarray, start: int) -> None:
        """A chunk's new states from its host copies (the staged dispatch
        issued them), `keep` their candidate indices."""
        self.disk.append(out.rows_h[keep].astype(np.uint32), out.parent_h[keep] + start,
                         out.act_h[keep])

    def end(self) -> _SpilledFrontier:
        # publish the level; the consumed level's segments go behind the
        # deletion barrier
        return _SpilledFrontier(self.disk.end_level(), self.dev)

    def abort(self) -> None:
        self.disk.abort_level()  # the partial next level: discarded

    def trace_view(self, depth: int):
        # O(depth) record reads, and it survives a resume
        return self.disk.plog.view() if self.disk.has_trace(depth) else None


def checkpoint_ident(model: Model, visited_backend: str, check_invariants: bool,
                     check_deadlock: bool, use_disk: bool = False) -> str:
    """The identity stamped into each checkpoint, byte for byte the JAX
    package's: a checkpoint resumes only the same model, constants,
    backend, invariant selection, deadlock setting and store (a resume
    never re-checks the levels already explored)."""
    spec = model.spec
    inv_names = ",".join(sorted(i.name for i in model.invariants)) if check_invariants else "-"
    return (
        f"{model.name}|lanes={spec.num_lanes}|backend={visited_backend}|"
        f"inv={inv_names}|dl={check_deadlock}|"
        + ",".join(f"{f.name}:{f.shape}:{f.lo}:{f.hi}" for f in spec.fields)
        + ("|store=disk" if use_disk else "")
    )


def check(
    model: Model,
    max_depth: Optional[int] = None,
    max_states: Optional[int] = None,
    store_trace: bool = True,
    min_bucket: int = 256,
    check_invariants: bool = True,
    progress=None,
    collect_levels: Optional[list] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    check_deadlock: bool = False,
    stats_path: Optional[str] = None,
    visited_backend: str = "device",
    chunk_size: int = 32768,
    visited_capacity_hint: Optional[int] = None,
    visited_capacity_exact: Optional[int] = None,
    compact_shift: int = 2,
    compact_gate: int = 4096,
    pipeline: Optional[str] = None,
    mem_budget=None,
    spill_dir: Optional[str] = None,
    store: str = "auto",
    disk_budget=None,
    run=None,
    governor: Optional[ResourceGovernor] = None,
    overlap: Optional[bool] = None,
    device=None,
) -> CheckResult:
    """Breadth-first exhaustive check of `model`; stops at the first
    violation.  Arguments mean what they mean for the JAX engine's check(),
    with its defaults and in its order.

    device: where the check runs; None is the card ("cuda"), which raises
    when CUDA is absent.  Pass "cpu" to run the plain versions of the
    kernels on the CPU.
    max_depth / max_states: stop at the first level boundary at that depth
    / with at least that many states; the unexpanded frontier still gets
    its invariant pass.
    store_trace: keep each level's parent pointers; without them a
    violation reports its state with an empty trace.
    check_invariants: False checks no invariant (deadlock still, if asked).
    progress: called as progress(depth, new, total) after each level.
    stats_path: append one heartbeat-enveloped JSON line per level (depth,
    frontier, enabled candidates, new, duplicates, total, wall ms of the
    level, of its expansion and of its host work, per-action enablement);
    the same records go to stats["levels"], which adds the level's
    overlap accounting (io_hidden_ms, io_exposed_ms, overlap_efficiency;
    in memory only, as in the JAX package).
    visited_backend: "device" (sorted set), "device-hash" (hash table) or
    "host" (the native C++ set; needs g++ at first use).
    visited_capacity_hint: size the sorted set for about this many states
    plus one chunk's headroom (the table for 4x as many), so it never
    grows on a run of roughly known size; visited_capacity_exact: start the
    sorted set at this capacity, no headroom added.
    pipeline: "fused", "legacy" or "device" (None: $KSPEC_PIPELINE, else
    "fused"); "fused" and "legacy" run the same per-chunk stages, "device"
    queues every gated chunk of a level on the card and reads the host once
    a level (``pipeline.DevicePipeline``; stats["device"] says how many
    levels ran so and why, if ever, it ran the per-chunk path instead);
    all three give the same result.  compact_shift/compact_gate select the
    candidate order of a chunk (``pipeline.compacts``).
    check_deadlock: report a reachable state with no enabled action as a
    violation of the pseudo-invariant "Deadlock".  A model's constraint
    prunes successors (not explored, not counted in the stats' enablement);
    deadlock is judged on the actions' guards before it.
    collect_levels: optional list that receives the init rows and each
    non-empty level's packed rows, int64[n, K], in discovery order.
    checkpoint_dir: save the visited set, the frontier, the level counts
    and the digest chain every `checkpoint_every` levels, keeping
    `checkpoint_keep` generations, and resume from the newest generation
    that verifies when one is there.  Without the disk tier a checkpointed
    run keeps no trace: a violation found after a resume reports its state
    with an empty trace.
    mem_budget / spill_dir / store: the disk tier (``storage/``).  `store`
    "disk", or "auto" with a `mem_budget` ("512M", "4G" or bytes; default
    4G), turns it on: the visited set becomes the host set bounded by the
    budget, spilling sorted bloom-gated runs to disk (visited_backend is
    forced to "host"), the frontier is spilled in segments and read a
    chunk at a time, and the trace lives in an on-disk parent log, which
    survives a resume.  The tier lives in `spill_dir` (default
    `<checkpoint_dir>/spill`, else a temporary `kspec-spill-` directory
    removed when the run completes); a checkpoint records its manifest,
    not its data.  stats["spill"] counts spills, merges and the bloom
    gates' traffic.
    disk_budget: byte budget for the spill + checkpoint directories
    (``resilience/resources.py``; $KSPEC_DISK_BUDGET is the env twin,
    $KSPEC_RSS_BUDGET and $KSPEC_LEVEL_DEADLINE arm the RSS and per-level
    deadline watchdogs).  Crossing the soft fraction reclaims (tmp janitor,
    eager merge, a fresh checkpoint, generation prune, deletion-barrier
    flush); a hard breach, or ENOSPC from any writer, saves a final
    checkpoint and raises ResourceExhausted (``cli check`` exit 75), whose
    checkpoint passes ``verify_checkpoint_dir`` and resumes bit for bit.
    run: an ``obs.RunContext`` (the port's ``obs/``): the run's stats,
    spans and metrics go to its directory under its run_id, each level
    record carries the run_id, and the manifest is finished with the
    result (or, on the typed exits 75 and 76, their status).  With
    run=None the tracer and registry of the thread are cleared and a bare
    `stats_path` gets the stream with no run_id.  A crash (an injected
    one, or any exception but the typed exits) leaves the manifest at
    "running" with the level's begin marker unmatched, and the run's
    tracer and registry still set, as in the JAX package.
    The gauge ``kspec_successor_launches_level`` counts the chunk step
    dispatches of the level (one per per-chunk step, the chunks of each
    dispatch of a device-resident level), where the JAX package counts
    XLA programs.
    governor: a ResourceGovernor to use in place of the env-derived one.
    overlap: the async overlap layer (``overlap.py``; None: $KSPEC_OVERLAP,
    else on; "on"/"off" and the other spellings of the JAX package's knob
    resolve as there).  On, the per-chunk loop stages two chunks (chunk k+1
    dispatched before chunk k is committed), the disk tier's k-way merges
    run on a worker thread (``kspec-io``) and checkpoint writes on another
    (``kspec-ckpt``, with `checkpoint_dir`); off is the serial path.  The
    result is the same either way: levels, total, diameter, violation and
    trace, the per-level stats but their clocks, and the digest chain.
    Worker errors re-raise on this thread at the next join (the level's
    start, blocking when a fault plan is armed, and the run's end) with
    their serial twins' typed exits.  No worker thread outlives the call.
    stats["overlap"] holds the layer's accounting (JAX's keys).

    $KSPEC_FAULT (``resilience/faults.py``) arms fault injection; a plan
    naming a site this engine does not wire is refused (ValueError).
    """
    # the encoding gate (KSPEC_ANALYZE=0 disables): an action that can write
    # outside its declared field ranges would be masked by the packer, so
    # the model is refused before anything is explored
    require_encoding_sound(model)
    if visited_backend not in VISITED_BACKENDS:
        raise ValueError(
            f"visited_backend must be one of {', '.join(VISITED_BACKENDS)}, "
            f"got {visited_backend!r}"
        )
    use_disk = resolve_store(store, mem_budget)
    if use_disk:
        # the disk tier spills the HOST level of the hierarchy; traces
        # ride the on-disk parent log instead of the in-RAM trace store
        visited_backend = "host"
    fault = FaultPlan.from_env()
    unwired = fault.unwired()
    if unwired:
        raise ValueError(
            f"fault plan {fault.spec!r}: site(s) {', '.join(unwired)} are not wired in "
            f"this engine (it wires {', '.join(sorted(f'{k}@{p}' for k, p in WIRED))})"
        )
    pipe_name = resolve_pipeline(pipeline)
    dev = resolve_device(device)
    # the async overlap layer ($KSPEC_OVERLAP, default on): kspec-io carries
    # the background spill-run merges, kspec-ckpt the checkpoint writes; the
    # two-slot chunk pipeline below needs no thread
    overlap_on = overlap_enabled(overlap)
    io_worker = AsyncWorker("kspec-io") if overlap_on else None
    ckpt_worker = (AsyncWorker("kspec-ckpt")
                   if overlap_on and checkpoint_dir is not None else None)
    workers = (io_worker, ckpt_worker)
    try:
        return _check(
            model, max_depth=max_depth, max_states=max_states, store_trace=store_trace,
            min_bucket=min_bucket, check_invariants=check_invariants, progress=progress,
            collect_levels=collect_levels, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, checkpoint_keep=checkpoint_keep,
            check_deadlock=check_deadlock, stats_path=stats_path,
            visited_backend=visited_backend, chunk_size=chunk_size,
            visited_capacity_hint=visited_capacity_hint,
            visited_capacity_exact=visited_capacity_exact, compact_shift=compact_shift,
            compact_gate=compact_gate, mem_budget=mem_budget, spill_dir=spill_dir,
            disk_budget=disk_budget, run=run, governor=governor, use_disk=use_disk,
            fault=fault, pipe_name=pipe_name, dev=dev, io_worker=io_worker,
            ckpt_worker=ckpt_worker,
        )
    finally:
        # no worker outlives the call: a completed run drained and closed
        # them; any other ending closes them here, discarding what they
        # hold (its own exception is already propagating)
        close_workers(workers, drain=False)


def _check(model: Model, *, max_depth, max_states, store_trace, min_bucket, check_invariants,
           progress, collect_levels, checkpoint_dir, checkpoint_every, checkpoint_keep,
           check_deadlock, stats_path, visited_backend, chunk_size, visited_capacity_hint,
           visited_capacity_exact, compact_shift, compact_gate, mem_budget, spill_dir,
           disk_budget, run, governor, use_disk, fault, pipe_name, dev, io_worker,
           ckpt_worker) -> CheckResult:
    """check() past its argument checks, with the overlap layer's workers
    (None where the layer is off, or for kspec-ckpt without checkpoints)."""
    overlap_on = io_worker is not None
    workers = (io_worker, ckpt_worker)
    # run_id-stamped stats/spans/metrics when a run context is given; the
    # bare stats_path stream otherwise
    obs_ = RunObserver(run, stats_path, engine="bfs")
    spec = model.spec
    K = spec.num_lanes
    C = model.total_fanout
    t0 = time.perf_counter()
    # the newest checkpointed level (None: not checkpointing); with the
    # async writer this is the newest SUBMITTED save (the save cadence),
    # and `ckpt_durable_depth` the newest promoted one, on which
    # level-keyed faults defer until it reaches their level
    ckpt_depth = None
    if checkpoint_dir is not None:
        ckpt_depth = 0
        checkpoint_every = max(1, int(checkpoint_every))
    chain = integrity.LevelDigestChain() if integrity.enabled() else None
    pipe = (DevicePipeline(model, visited_backend, check_invariants, check_deadlock,
                           compact_shift, compact_gate)
            if pipe_name == "device" else None)
    collect_stats = obs_.collect
    stats_levels = []
    visited = None

    disk = None
    ephemeral_spill = None
    if use_disk:
        budget = parse_mem_budget(mem_budget) if mem_budget is not None else DEFAULT_MEM_BUDGET
        sd = spill_dir or (os.path.join(checkpoint_dir, "spill") if checkpoint_dir else None)
        if sd is None:
            # anonymous spill space, removed after a completed run (a
            # crashed one cannot be resumed without a checkpoint)
            sd = ephemeral_spill = tempfile.mkdtemp(prefix="kspec-spill-")
        disk = DiskTierStore(
            sd, budget, lanes=K,
            gc_barrier=checkpoint_keep if checkpoint_dir else 0,
            seg_rows=int(os.environ.get("KSPEC_SPILL_SEG_ROWS", str(1 << 18))),
            runs_per_merge=int(os.environ.get("KSPEC_SPILL_RUNS_PER_MERGE", "8")),
            fault_plan=fault,
            trace=store_trace or checkpoint_dir is not None,
            merge_worker=io_worker,
        )

    def drop_ephemeral_spill():
        if ephemeral_spill is not None:
            shutil.rmtree(ephemeral_spill, ignore_errors=True)

    inits = [
        {k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in s.items()}
        for s in model.init_states()
    ]
    init_packed = torch.stack([spec.pack(s) for s in inits]).numpy()
    init_packed = torch.from_numpy(np.unique(init_packed, axis=0)).to(dev)
    n0 = init_packed.shape[0]
    levels = [n0]
    total = n0
    # where each level's new states go: tensors in RAM, or the tier's
    # frontier segments and parent log; in RAM a checkpointed run keeps no
    # trace (the trace store is not saved, so a resume could not walk it)
    sink = (_DiskLevels(disk, dev) if disk is not None
            else _RamLevels(init_packed, store_trace and checkpoint_dir is None))
    if collect_levels is not None:
        collect_levels.append(init_packed)

    def decode_state(packed_row):
        """A packed row: an int64 tensor, or a spilled level's uint32 lanes."""
        if isinstance(packed_row, np.ndarray):
            packed_row = torch.from_numpy(packed_row.astype(np.int64))
        s = {k: v.cpu().numpy() for k, v in spec.unpack(packed_row).items()}
        return model.decode(s) if model.decode else s

    def violation_at(name, depth, idx, frontier):
        """The violation of row `idx` of `frontier`, the level at `depth`."""
        view = sink.trace_view(depth)
        if view is not None:
            return walk_trace(view, model.actions, decode_state, name, depth, idx)
        return Violation(invariant=name, depth=depth, state=decode_state(frontier.row(idx)),
                         trace=[])

    staged_peak = 0  # most chunks staged at once (<= 2)
    sync_io_s = 0.0  # wall spent on synchronous checkpoint writes

    def finish(violation):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        stats = {
            "device": str(dev),
            "visited_backend": visited_backend,
            "pipeline": pipe_name,
            "fanout": C,
            "lanes": K,
        }
        if visited is not None:
            stats.update(visited_capacity=visited.capacity, **visited.stats())
        if collect_stats:
            stats["levels"] = stats_levels
        if pipe is not None:
            # how many levels ran device-resident, and why (if ever) the
            # run left the device path for the per-chunk one
            stats["device"] = {"levels": pipe.levels, "fallback": pipe.fallback}
        if governor is not None:
            stats["governor"] = governor.stats()
        # the overlap layer's accounting: the staged-chunk bound is
        # structural (two slots)
        stats["overlap"] = {
            "enabled": overlap_on,
            "staged_chunks_peak": staged_peak,
            "sync_ckpt_io_s": round(sync_io_s, 4),
            **({"io_worker": io_worker.stats()} if io_worker is not None else {}),
            **({"ckpt_worker": ckpt_worker.stats()} if ckpt_worker is not None else {}),
        }
        drop_ephemeral_spill()
        close_workers(workers, drain=True)
        res = CheckResult(
            model=model.name,
            levels=levels,
            total=total,
            diameter=len(levels) - 1,
            violation=violation,
            seconds=dt,
            states_per_sec=total / max(dt, 1e-9),
            stats=stats,
        )
        obs_.finish(res)
        obs_.close()
        return res

    # invariants on the init states: a violation here has its one-state trace
    if check_invariants:
        bad = invariant_stage(model, spec.unpack(init_packed))
        if bad is not None:
            s = decode_state(init_packed[bad[1]])
            return finish(Violation(bad[0], 0, s, [("<init>", s)]))
    obs_.config(
        model=model.name,
        visited_backend=visited_backend,
        store="disk" if use_disk else "ram",
        mem_budget=mem_budget,
        chunk_size=chunk_size,
        checkpoint_dir=checkpoint_dir,
        platform="gpu" if dev.type == "cuda" else dev.type,
    )

    def spill_ref_errors(arrays: dict) -> list:
        """The disk tier's load validator: every spill run and frontier
        segment a generation references must pass its CRC, else the
        generation falls back to an older one."""
        if disk is None or "spill_manifest" not in arrays:
            return []
        man = json.loads(str(arrays["spill_manifest"]))
        errs = integrity.spill_run_errors(disk.fpset.dir, (man.get("fpset") or {}).get("runs", ()))
        try:
            FrontierReader(disk.frontier_dir, man["frontier"], verify=True)
        except SegmentCorrupt as e:
            errs.append(f"referenced frontier segment corrupt: {e}")
        return errs

    chunk = next_pow2(max(min_bucket, chunk_size))
    depth = 0
    ckpt_store = None
    loaded = None
    if checkpoint_dir is not None:
        ckpt_store = CheckpointStore(
            checkpoint_dir, CHECKPOINT_BASENAME,
            ident=checkpoint_ident(model, visited_backend, check_invariants, check_deadlock,
                                   use_disk),
            keep=checkpoint_keep,
            # a generation whose chain does not verify, or whose referenced
            # spill files do not, falls back like a checksum failure
            validators=((integrity.checkpoint_chain_errors, spill_ref_errors)
                        if chain is not None else (spill_ref_errors,)),
            fault_plan=fault,
        )
        if ckpt_worker is not None:
            ckpt_store.attach_writer(ckpt_worker)
        loaded = ckpt_store.load()
    if loaded is not None:
        snap, _gen = loaded
        if disk is not None:
            visited = _TierVisited.resume(snap, disk)
            frontier = _SpilledFrontier(disk.pending(), dev)
        else:
            visited = _RESUMES[visited_backend].resume(snap, dev)
            frontier = _RamFrontier(from_u32(snap["frontier"], dev))
        levels = snap["levels"].tolist()
        total = int(snap["total"])
        depth = ckpt_depth = int(snap["depth"])
        # faults at or below the resume level count as fired
        fault.set_start_depth(depth)
        if chain is not None:
            # a resumed run extends the stamped chain; a file without one
            # gives an unanchored chain (counts only)
            chain = (integrity.LevelDigestChain.from_array(snap["digest_chain"])
                     if "digest_chain" in snap else integrity.LevelDigestChain.from_levels(levels))
    else:
        hi0, lo0 = fp_stage(spec, init_packed)
        frontier = _RamFrontier(init_packed)
        if disk is not None:
            visited = _TierVisited.fresh(disk, init_packed, fps_u64(hi0, lo0))
            frontier = _SpilledFrontier(disk.pending(), dev)
        elif visited_backend == "device":
            visited = _SortedVisited.fresh(hi0, lo0, next_pow2(max(
                n0, min_bucket * C, 2, visited_capacity_exact or 0,
                (visited_capacity_hint + chunk * C) if visited_capacity_hint else 0,
            )))
        elif visited_backend == "device-hash":
            visited = _HashVisited(hi0, lo0, next_pow2(max(
                _HASH_MIN_CAP, 4 * (visited_capacity_hint or visited_capacity_exact or 0))))
        else:
            visited = _HostVisited(fps_u64(hi0, lo0))
        if chain is not None:
            chain.fold(fps_u64(hi0, lo0))
            chain.seal(0, n0)

    # the async writer's bookkeeping: each in-flight save's deletion-barrier
    # watermark (the barrier advances, once the save promotes, for exactly
    # the files scheduled before its snapshot)
    ckpt_durable_depth = ckpt_depth
    ckpt_barrier_tokens: list = []

    def ckpt_reap(completed) -> None:
        nonlocal ckpt_durable_depth
        for d, _path in completed:
            ckpt_durable_depth = d if ckpt_durable_depth is None else max(ckpt_durable_depth, d)
            if disk is not None:
                tok = ckpt_barrier_tokens.pop(0) if ckpt_barrier_tokens else None
                disk.fpset.deleter.on_save(upto=tok)

    def ckpt_poll(block: bool = False) -> None:
        """The join point of the async saves: surfaces the writer's errors
        (typed ENOSPC, injected crashes) on this thread and advances the
        durable depth and the deletion barrier."""
        if ckpt_worker is None or ckpt_store is None:
            return
        ckpt_reap(ckpt_store.drain_async() if block else ckpt_store.poll_async())

    def save_checkpoint(sync: bool = False):
        """Snapshot everything mutable now, on this thread (every
        device-to-host copy is made here), and write it: on the writer
        thread (the chain check of the dump, the checksummed write, the
        rotation, the promote and the chain read-back), or here when
        `sync` or the layer is off."""
        nonlocal ckpt_depth, ckpt_durable_depth, sync_io_s
        run_async = ckpt_worker is not None and not sync
        t_sync0 = time.perf_counter()
        d_save = depth
        levels_arr = np.asarray(levels)
        anchored = chain is not None and chain.anchored
        if anchored and fault.flip("ckpt", d_save, ckpt_depth=ckpt_durable_depth):
            # corrupt metadata before the CRC manifest is built: every
            # checksum passes over it, only the chain read-back flags it
            levels_arr = levels_arr.copy()
            integrity.flip_bit(levels_arr)
        stamp = {"digest_chain": chain.to_array()} if anchored else {}
        extra = visited.save_arrays()
        # None for a tier generation: its hot dump is a subset of the set,
        # and its runs carry their own CRCs
        dump = integrity.visited_fps(extra)
        pre_write = None
        if anchored and dump is not None:
            if fault.flip("fpset", d_save, ckpt_depth=ckpt_durable_depth):
                key = next(iter(extra))
                extra[key] = np.array(extra[key], copy=True)
                integrity.flip_bit(extra[key])
                dump = integrity.visited_fps(extra)
            # the dump must digest to the chain's running total before it is
            # written: corruption found here never enters a checkpoint.  The
            # writer checks a snapshot of the chain (it goes on growing here)
            chain_snap = (integrity.LevelDigestChain.from_array(chain.to_array())
                          if run_async else chain)

            def pre_write(chain_snap=chain_snap, dump=dump):
                integrity.count_check()
                chain_snap.verify_visited(dump, depth=d_save)

        def after_promote(path):
            if anchored:
                integrity.readback_chain(path, depth=d_save)

        arrays = dict(**frontier.save_arrays(), vcap=visited.capacity, levels=levels_arr,
                      total=total, **extra, **stamp)
        if run_async:
            if disk is not None:
                ckpt_barrier_tokens.append(disk.fpset.deleter.mark())
            ckpt_store.save_async(d_save, arrays, pre_write=pre_write,
                                  after_promote=after_promote)
        else:
            if pre_write is not None:
                pre_write()
            path = ckpt_store.save(d_save, arrays)
            if disk is not None:
                disk.on_checkpoint_saved()  # a new durable generation: the deletion barrier advances
            after_promote(path)
            ckpt_durable_depth = (d_save if ckpt_durable_depth is None
                                  else max(ckpt_durable_depth, d_save))
            sync_io_s += time.perf_counter() - t_sync0
        ckpt_depth = d_save

    if governor is None:
        governor = ResourceGovernor.from_env(
            disk_budget=disk_budget,
            watch_dirs=[disk.dir if disk is not None else None, checkpoint_dir],
            fault_plan=fault,
        )

    def final_save():
        """Checkpoint-then-clean-exit: persist the level just completed,
        off the checkpoint_every cadence if need be, synchronously and
        after the async tail (the typed exit promises a DURABLE state)."""
        if ckpt_store is None:
            return
        ckpt_poll(block=True)
        if ckpt_depth != depth or ckpt_durable_depth != depth:
            save_checkpoint(sync=True)

    def reclaim():
        """Soft-breach reclamation, in dependency order: tmp janitor,
        eager run merge, a fresh checkpoint (referencing the merged
        state), prune older generations, flush the deletion barrier
        (everything still pending was referenced only by them).  The
        store's steps quiesce the merge worker first, and the blocking
        checkpoint join keeps a reclaim from racing an in-flight write."""
        merged = False
        if disk is not None:
            disk.sweep_tmp()
            merged = disk.reclaim_merge()
        if ckpt_store is not None:
            ckpt_poll(block=True)
            if merged or ckpt_depth != depth or ckpt_durable_depth != depth:
                save_checkpoint(sync=True)
            ckpt_store.prune(keep_gens=1)
            if disk is not None:
                disk.flush_deleted()

    # the host copies a chunk's commit reads: its fingerprint pair keys
    # (the host set's insert, the chain's fold) and, on the tier, its rows,
    # parents and actions (the disk append), issued at the end of its
    # dispatch into page-locked buffers
    host_copies = ((("keys",) if chain is not None or visited_backend == "host" else ())
                   + (("rows",) if disk is not None else ()))
    slots = HostSlots()
    violation = None
    exhausted = None
    integrity_fail = None
    verdict = None  # (frontier index, invariant name)
    lvl_new = lvl_launches = 0
    step_s = host_s = 0.0
    act_en = None

    def commit(st) -> bool:
        """Commit one staged chunk, strictly in chunk order: wait for its
        host copies, take its verdict, or insert its candidates into the
        visited set, fold the chain and append the new states.  -> True
        when a verdict ends the level."""
        nonlocal verdict, lvl_new, lvl_launches, step_s, host_s
        start, rows_n, bucket, handle, dispatch_s, t_staged = st
        queued_s = time.perf_counter() - t_staged
        if visited_backend == "device":
            # the sorted set grows on its size after the previous chunk's
            # merge, as the JAX engine's dispatch-time dedup sees it
            visited.reserve(bucket * C)
        t_wait = time.perf_counter()
        out = handle.finalize()
        wait_s = time.perf_counter() - t_wait
        if out.verdict is not None:
            verdict = (start + out.verdict[0], out.verdict[1])
            return True
        lvl_launches += 1
        step_s += dispatch_s + wait_s
        # dispatch_ms: issuing the chunk (its host reads included);
        # wait_ms: the residual wait for its host copies; queued_ms: how
        # long it sat staged while the previous chunk committed
        obs_.chunk_span(
            "step", dispatch_s + wait_s, depth=depth, start=start, rows=rows_n,
            bucket=bucket, launches=1, dispatch_ms=round(dispatch_s * 1e3, 2),
            wait_ms=round(wait_s * 1e3, 2), queued_ms=round(queued_s * 1e3, 2),
        )
        t_host = time.perf_counter()
        if collect_stats:
            act_en.add_(out.act_en)
        # the span's `new`, as the JAX package counts it: the rows handed
        # to the host set or table, the new states of the sorted set
        nn = out.rows.shape[0]
        if nn:
            if visited.host_keys:
                keep = visited.insert(out.keys)
                if chain is not None:
                    chain.fold(out.keys[keep].view(np.uint64))
                won = keep.shape[0]
                if won:
                    sink.append_kept(out, keep, start)
            else:
                win = visited.insert(out.hi, out.lo)
                if chain is not None:
                    chain.fold(out.keys[win.cpu().numpy()].view(np.uint64))
                won = win.shape[0]
                sink.append(out.rows[win], out.parent[win] + start, out.act[win])
                if visited_backend == "device":
                    nn = won
            lvl_new += won
        obs_.chunk_span(
            "host-assembly", time.perf_counter() - t_host, depth=depth, start=start,
            new=nn, backend=visited_backend,
        )
        host_s += time.perf_counter() - t_host
        return False

    try:
        while frontier.rows > 0:
            # the level-start join: adopt finished background merges and
            # promoted checkpoints, surfacing any worker error (typed
            # faults, ENOSPC) on this thread before more work builds on
            # them.  With a fault plan armed the join blocks, so that
            # injection (crash deferral, flip gating, enospc surfacing)
            # does not depend on the worker threads' timing
            ckpt_poll(block=bool(fault.specs))
            if disk is not None:
                if fault.specs:
                    disk.quiesce()
                disk.poll_async()
            lvl_io0 = worker_counters(workers)
            lvl_sync_io0 = sync_io_s
            # crash deferral keys on the DURABLE checkpoint depth, so an
            # in-flight async save never arms a crash whose restart would
            # not converge
            fault.crash("level", depth, ckpt_depth=ckpt_durable_depth)
            if chain is not None:
                if fault.flip("frontier", depth, ckpt_depth=ckpt_durable_depth):
                    frontier.flip()
                frontier.verify(chain, depth, spec)
            if max_depth is not None and depth >= max_depth:
                break
            if max_states is not None and total >= max_states:
                break
            f_total = frontier.rows
            t_level = time.perf_counter()
            # begin marker (ph=B): a crash mid-level leaves it unmatched,
            # which is what `cli report` uses to pin where the run died
            obs_.level_begin(depth + 1, f_total)
            governor.level_begin(depth + 1)  # arm the per-level deadline
            sink.begin(depth + 1)
            step_s = host_s = 0.0
            lvl_launches = 0  # chunk step dispatches (the launches gauge)
            lvl_probe_ms = 0.0  # the device level's one batched host probe
            act_en = torch.zeros(len(model.actions), dtype=torch.int64, device=dev) \
                if collect_stats else None
            lvl_new = 0
            verdict = None
            dev_handled = 0
            source = frontier  # the level's rows, staged on the card for a device span
            plan = pipe.plan_level(f_total, chunk, min_bucket) if pipe is not None else None
            if plan is not None:
                governor.poll(depth)
                refusal = frontier.stage_refusal()
                if refusal is not None:
                    # the per-chunk path from here on, streaming chunks from disk
                    pipe.mark_fallback(refusal, depth)
                    plan = None
                else:
                    source = _RamFrontier(frontier.read_all())
            if plan is not None:
                # the device-resident span: every gated chunk queued on the
                # card, one host read; a sub-gate tail chunk follows below at
                # its serial offset.  Not staged: its one read blocks on the
                # span (the workers go on meanwhile)
                t_step = time.perf_counter()
                out = pipe.run_level(source.read_all(), plan, visited)
                t_host = time.perf_counter()
                step_s += t_host - t_step
                dev_handled = plan[2]
                launches = plan[1] * out.reads
                lvl_launches += launches
                # the level blocks on its one read, so its whole wall is
                # device wait; the span comes before the verdict, as in the
                # JAX package
                obs_.chunk_span(
                    "step", t_host - t_step, depth=depth, start=0, rows=plan[2],
                    bucket=plan[0], launches=launches, chunks=plan[1],
                    pipeline="device", dispatch_ms=0.0,
                    wait_ms=round((t_host - t_step) * 1e3, 2), queued_ms=0.0,
                )
                if out.verdict is not None:
                    verdict = out.verdict
                    dev_handled = f_total
                else:
                    if collect_stats:
                        act_en += torch.tensor(out.act_en, dtype=torch.int64, device=dev)
                    rows, parent, act = out.rows, out.parent, out.act
                    nn = rows.shape[0]
                    if visited_backend == "host":
                        # the deferred probe: one batched insert of the
                        # level's novel candidates, in candidate order
                        t_probe = time.perf_counter()
                        keep = visited.insert_keys(out.keys)
                        if chain is not None:
                            chain.fold(out.keys[keep].view(np.uint64))
                        idx = torch.from_numpy(keep).to(dev)
                        rows, parent, act = rows[idx], parent[idx], act[idx]
                        probe_s = time.perf_counter() - t_probe
                        lvl_probe_ms += probe_s * 1e3
                        obs_.chunk_span(
                            "host-probe", probe_s, depth=depth, rows=nn,
                            new=int(keep.shape[0]), backend=visited_backend,
                            batched="level",
                        )
                    elif nn:
                        visited.merge_level(out.lkeys)
                        if chain is not None:
                            chain.fold_digest(*out.digest)
                    if rows.shape[0]:
                        lvl_new += rows.shape[0]
                        sink.append(rows, parent, act)
                    obs_.chunk_span(
                        "host-assembly", time.perf_counter() - t_host, depth=depth,
                        start=0, new=nn, backend=visited_backend,
                    )
                host_s += time.perf_counter() - t_host
            # the two-slot staged chunk pipeline: chunk k+1 is dispatched
            # before chunk k is committed, so chunk k's host commit runs
            # while the card finishes chunk k+1's tail.  At most two chunks
            # are staged; commits run strictly in chunk order, so counts,
            # novelty, the first violation and traces are the serial path's,
            # which is this loop with the layer off (each dispatch followed
            # by its commit).  A verdict is known at dispatch (its host
            # reads): that chunk is committed before another is dispatched,
            # so no chunk is launched that the serial path would not launch
            staged = None
            for start, piece in source.chunks(chunk, dev_handled):
                governor.poll(depth)  # the deadline watchdog
                bucket = next_pow2(max(piece.shape[0], min_bucket))
                if visited_backend == "device-hash":
                    # the table grows before a chunk is dispatched, as the
                    # JAX engine's does: ahead of the staged chunk's commit
                    visited.reserve(bucket * C)
                t_step = time.perf_counter()
                handle = run_chunk(model, piece, compacts(bucket, compact_shift, compact_gate),
                                   check_deadlock, check_invariants, collect_stats,
                                   host_copies, slots)
                cur = (start, piece.shape[0], bucket, handle, time.perf_counter() - t_step,
                       time.perf_counter())
                if not overlap_on:
                    if commit(cur):
                        break
                    continue
                staged_peak = max(staged_peak, 2 if staged is not None else 1)
                if staged is not None and commit(staged):
                    staged = None  # the chunk just dispatched: discarded uncommitted
                    break
                staged = cur
                if handle.verdict is not None:
                    commit(staged)
                    staged = None
                    break
            if staged is not None:
                commit(staged)
            staged = None

            if verdict is not None:
                sink.abort()
                idx, name = verdict
                violation = violation_at(name, depth, idx, frontier)
                break

            next_frontier = sink.end()
            depth += 1
            if lvl_new:
                levels.append(lvl_new)
                total += lvl_new
            if chain is not None:
                if lvl_new:
                    chain.seal(depth, lvl_new)
                else:
                    chain.reset_fold()
            if collect_stats:
                en = act_en.tolist()
                enabled = sum(en)
                # heartbeat-enveloped (kind/ts/unix); with a run context the
                # observer also stamps run_id, closes the level span and
                # folds the metrics registry
                rec = obs_.level(
                    depth=depth,
                    frontier=f_total,
                    enabled_candidates=enabled,
                    new=lvl_new,
                    duplicates=enabled - lvl_new,
                    total=total,
                    level_ms=round((time.perf_counter() - t_level) * 1e3, 1),
                    step_ms=round(step_s * 1e3, 1),
                    host_ms=round(host_s * 1e3, 1),
                    action_enablement={a.name: c for a, c in zip(model.actions, en)},
                )
                # the in-memory record: the emitted one, and below the
                # level's overlap accounting
                stats_levels.append(dict(rec))
                _met.set_gauge("kspec_successor_launches_level", lvl_launches)
                if lvl_probe_ms:
                    # the device level's one batched host probe, in ms
                    _met.set_gauge("kspec_host_probe_ms", round(lvl_probe_ms, 2))
            if collect_levels is not None and lvl_new:
                collect_levels.append(next_frontier.read_all())
            if progress:
                progress(depth, lvl_new, total)
            frontier = next_frontier
            if ckpt_store is not None and depth % checkpoint_every == 0:
                save_checkpoint()
            # level-boundary governance: pressure, the injected stall,
            # soft-breach reclamation, the hard breach's typed clean exit
            governor.level_end(depth, reclaim=reclaim, save_hook=final_save)
            if collect_stats:
                # the level's overlap accounting (the JAX package's): hidden
                # = the workers' busy wall not re-exposed as this thread's
                # blocking; exposed = blocking waits on the workers plus
                # synchronous checkpoint writes
                busy1, blk1 = worker_counters(workers)
                hid = max(0.0, (busy1 - lvl_io0[0]) - (blk1 - lvl_io0[1]))
                exp = (blk1 - lvl_io0[1]) + (sync_io_s - lvl_sync_io0)
                eff = hid / (hid + exp) if (hid + exp) > 1e-9 else 1.0
                stats_levels[-1].update(io_hidden_ms=round(hid * 1e3, 2),
                                        io_exposed_ms=round(exp * 1e3, 2),
                                        overlap_efficiency=round(eff, 4))
                _met.set_gauge("kspec_overlap_efficiency", round(eff, 4))
                _met.inc("kspec_io_hidden_ms_total", round(hid * 1e3, 2))
                _met.inc("kspec_io_exposed_ms_total", round(exp * 1e3, 2))
        # the async tail, drained inside the typed-error scope: a pending
        # checkpoint's ENOSPC or a background merge's injected fault takes
        # the same typed exit as its synchronous twin
        ckpt_poll(block=True)
        if disk is not None:
            disk.quiesce()
    except ResourceExhausted as e:
        exhausted = e
    except IntegrityError as e:
        integrity_fail = e
    except (RunCorrupt, SegmentCorrupt, ParentLogCorrupt) as e:
        # a spill file failed its read-side checksum: silent on-disk
        # corruption, typed like every other integrity violation
        integrity_fail = IntegrityError("storage", str(e), depth=depth)
    except OSError as e:
        if not is_disk_full(e):
            raise
        # ENOSPC from a writer: every writer cleaned up its tmp, so the
        # promoted state is intact
        exhausted = ResourceExhausted("enospc", str(e), depth=depth)
    if integrity_fail is not None:
        # the newest durable generation predates the corruption: nothing
        # more is saved.  The manifest records the typed terminal (`cli
        # report`'s integrity beat); the terminal path's own writes are
        # best-effort
        try:
            integrity.record_violation(integrity_fail)
            sink.abort()
            obs_.abort(
                "integrity-violation",
                site=integrity_fail.site,
                depth=integrity_fail.depth,
                detail=integrity_fail.detail[:300],
                distinct_states=total,
            )
            obs_.close()
        except OSError:
            pass
        drop_ephemeral_spill()
        raise integrity_fail
    if exhausted is not None:
        # the manifest records why (`cli report`'s RESOURCE_EXHAUSTED
        # beat); a second ENOSPC on the same full disk must not turn the
        # typed exit into a crash
        try:
            sink.abort()
            obs_.abort(
                "resource-exhausted",
                reason=exhausted.reason,
                depth=exhausted.depth,
                detail=exhausted.detail,
                distinct_states=total,
                **governor.stats(),
            )
            obs_.close()
        except OSError:
            pass
        raise exhausted

    if violation is None and check_invariants and frontier.rows:
        # the loop was cut (max_depth/max_states) before the remaining
        # frontier was expanded: its states still need their invariant pass
        bad = invariant_stage(model, spec.unpack(frontier.read_all()))
        if bad is not None:
            violation = violation_at(bad[0], depth, bad[1], frontier)
    return finish(violation)
