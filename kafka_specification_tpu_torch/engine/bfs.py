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
from ..ops import dedup, hashset
from ..ops.cuda_hashset import probe_insert
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
from ..resilience.heartbeat import append_jsonl, heartbeat_record
from .pipeline import (DevicePipeline, compacts, fp_stage, grow_visited, invariant_stage, next_pow2,
                       run_chunk, sorted_dedup_stage)

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

    def __init__(self, fps: np.ndarray, initial_capacity: int = 1 << 16):
        self.set = FpSet(initial_capacity)  # builds fpset.cpp at first use; raises without g++
        self.set.insert(fps)

    @classmethod
    def resume(cls, snap: dict, dev):
        fps = snap["host_fps"]
        return cls(fps, max(64, 2 * len(fps)))

    def reserve(self, width: int):
        pass  # the set grows itself

    def insert(self, hi, lo) -> torch.Tensor:
        """-> candidate indices of the new states, in candidate order."""
        new = self.set.insert(fps_u64(hi, lo))
        return torch.from_numpy(np.flatnonzero(new)).to(hi.device)

    def insert_keys(self, keys: np.ndarray) -> np.ndarray:
        """One batched insert of fingerprint pair keys (int64 bit
        patterns, in candidate order) -> indices of the new ones."""
        return np.flatnonzero(self.set.insert(keys.view(np.uint64)))

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
    governor: Optional[ResourceGovernor] = None,
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
    the same records go to stats["levels"].
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
    governor: a ResourceGovernor to use in place of the env-derived one.

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
    spec = model.spec
    K = spec.num_lanes
    C = model.total_fanout
    t0 = time.perf_counter()
    # the newest durably checkpointed level (None: not checkpointing);
    # level-keyed faults defer until it reaches their level
    ckpt_depth = None
    if checkpoint_dir is not None:
        ckpt_depth = 0
        checkpoint_every = max(1, int(checkpoint_every))
    chain = integrity.LevelDigestChain() if integrity.enabled() else None
    pipe = (DevicePipeline(model, visited_backend, check_invariants, check_deadlock,
                           compact_shift, compact_gate)
            if pipe_name == "device" else None)
    collect_stats = stats_path is not None
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
        drop_ephemeral_spill()
        return CheckResult(
            model=model.name,
            levels=levels,
            total=total,
            diameter=len(levels) - 1,
            violation=violation,
            seconds=dt,
            states_per_sec=total / max(dt, 1e-9),
            stats=stats,
        )

    # invariants on the init states: a violation here has its one-state trace
    if check_invariants:
        bad = invariant_stage(model, spec.unpack(init_packed))
        if bad is not None:
            s = decode_state(init_packed[bad[1]])
            return finish(Violation(bad[0], 0, s, [("<init>", s)]))

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

    def save_checkpoint():
        nonlocal ckpt_depth
        levels_arr = np.asarray(levels)
        anchored = chain is not None and chain.anchored
        if anchored and fault.flip("ckpt", depth, ckpt_depth=ckpt_depth):
            # corrupt metadata before the CRC manifest is built: every
            # checksum passes over it, only the chain read-back flags it
            levels_arr = levels_arr.copy()
            integrity.flip_bit(levels_arr)
        stamp = {"digest_chain": chain.to_array()} if anchored else {}
        extra = visited.save_arrays()
        # None for a tier generation: its hot dump is a subset of the set,
        # and its runs carry their own CRCs
        dump = integrity.visited_fps(extra)
        if anchored and dump is not None:
            if fault.flip("fpset", depth, ckpt_depth=ckpt_depth):
                key = next(iter(extra))
                extra[key] = np.array(extra[key], copy=True)
                integrity.flip_bit(extra[key])
                dump = integrity.visited_fps(extra)
            # the dump must digest to the chain's running total before it is
            # written: corruption found here never enters a checkpoint
            chain.verify_visited(dump, depth=depth)
        path = ckpt_store.save(depth, dict(**frontier.save_arrays(), vcap=visited.capacity,
                                           levels=levels_arr, total=total, **extra, **stamp))
        if disk is not None:
            disk.on_checkpoint_saved()  # a new durable generation: the deletion barrier advances
        if anchored:
            integrity.readback_chain(path, depth=depth)
        ckpt_depth = depth

    if governor is None:
        governor = ResourceGovernor.from_env(
            disk_budget=disk_budget,
            watch_dirs=[disk.dir if disk is not None else None, checkpoint_dir],
            fault_plan=fault,
        )

    def final_save():
        """Checkpoint-then-clean-exit: persist the level just completed,
        off the checkpoint_every cadence if need be."""
        if ckpt_store is not None and ckpt_depth != depth:
            save_checkpoint()

    def reclaim():
        """Soft-breach reclamation, in dependency order: tmp janitor,
        eager run merge, a fresh checkpoint (referencing the merged
        state), prune older generations, flush the deletion barrier
        (everything still pending was referenced only by them)."""
        merged = False
        if disk is not None:
            disk.sweep_tmp()
            merged = disk.reclaim_merge()
        if ckpt_store is not None:
            if merged or ckpt_depth != depth:
                save_checkpoint()
            ckpt_store.prune(keep_gens=1)
            if disk is not None:
                disk.flush_deleted()

    violation = None
    exhausted = None
    integrity_fail = None
    try:
        while frontier.rows > 0:
            fault.crash("level", depth, ckpt_depth=ckpt_depth)
            if chain is not None:
                if fault.flip("frontier", depth, ckpt_depth=ckpt_depth):
                    frontier.flip()
                if chain.anchored and depth < len(chain.entries):
                    frontier.verify(chain, depth, spec)
            if max_depth is not None and depth >= max_depth:
                break
            if max_states is not None and total >= max_states:
                break
            f_total = frontier.rows
            t_level = time.perf_counter()
            governor.level_begin(depth + 1)  # arm the per-level deadline
            sink.begin(depth + 1)
            step_s = host_s = 0.0
            act_en = torch.zeros(len(model.actions), dtype=torch.int64, device=dev) \
                if collect_stats else None
            lvl_new = 0
            verdict = None  # (frontier index, invariant name)
            dev_handled = 0
            source = frontier  # the level's rows, staged on the card for a device span
            plan = pipe.plan_level(f_total, chunk, min_bucket) if pipe is not None else None
            if plan is not None:
                governor.poll(depth)
                refusal = frontier.stage_refusal()
                if refusal is not None:
                    # the per-chunk path from here on, streaming chunks from disk
                    pipe.fallback = refusal
                    plan = None
                else:
                    source = _RamFrontier(frontier.read_all())
            if plan is not None:
                # the device-resident span: every gated chunk queued on the
                # card, one host read; a sub-gate tail chunk follows below at
                # its serial offset
                t_step = time.perf_counter()
                out = pipe.run_level(source.read_all(), plan, visited)
                t_host = time.perf_counter()
                step_s += t_host - t_step
                dev_handled = plan[2]
                if out.verdict is not None:
                    verdict = out.verdict
                    dev_handled = f_total
                else:
                    if collect_stats:
                        act_en += torch.tensor(out.act_en, dtype=torch.int64, device=dev)
                    rows, parent, act = out.rows, out.parent, out.act
                    if visited_backend == "host":
                        # the deferred probe: one batched insert of the
                        # level's novel candidates, in candidate order
                        keep = visited.insert_keys(out.keys)
                        if chain is not None:
                            chain.fold(out.keys[keep].view(np.uint64))
                        idx = torch.from_numpy(keep).to(dev)
                        rows, parent, act = rows[idx], parent[idx], act[idx]
                    elif rows.shape[0]:
                        visited.merge_level(out.lkeys)
                        if chain is not None:
                            chain.fold_digest(*out.digest)
                    if rows.shape[0]:
                        lvl_new += rows.shape[0]
                        sink.append(rows, parent, act)
                host_s += time.perf_counter() - t_host
            for start, piece in source.chunks(chunk, dev_handled):
                governor.poll(depth)  # the deadline watchdog
                t_step = time.perf_counter()
                bucket = next_pow2(max(piece.shape[0], min_bucket))
                visited.reserve(bucket * C)
                out = run_chunk(model, piece, compacts(bucket, compact_shift, compact_gate),
                                check_deadlock, check_invariants, collect_stats)
                t_host = time.perf_counter()
                step_s += t_host - t_step
                if out.verdict is not None:
                    verdict = (start + out.verdict[0], out.verdict[1])
                    break
                if collect_stats:
                    act_en += out.act_en
                if out.rows.shape[0]:
                    win = visited.insert(out.hi, out.lo)
                    if chain is not None:
                        chain.fold(fps_u64(out.hi[win], out.lo[win]))
                    sink.append(out.rows[win], out.parent[win] + start, out.act[win])
                    lvl_new += win.shape[0]
                host_s += time.perf_counter() - t_host

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
                rec = heartbeat_record(
                    "level",
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
                append_jsonl(stats_path, rec)
                stats_levels.append(rec)
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
    if integrity_fail is not None or exhausted is not None:
        sink.abort()
    if integrity_fail is not None:
        # the newest durable generation predates the corruption: nothing
        # more is saved
        drop_ephemeral_spill()
        raise integrity_fail
    if exhausted is not None:
        raise exhausted

    if violation is None and check_invariants and frontier.rows:
        # the loop was cut (max_depth/max_states) before the remaining
        # frontier was expanded: its states still need their invariant pass
        bad = invariant_stage(model, spec.unpack(frontier.read_all()))
        if bad is not None:
            violation = violation_at(bad[0], depth, bad[1], frontier)
    return finish(violation)
