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
"""

from __future__ import annotations

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


_RESUMES = {"device": _SortedVisited, "device-hash": _HashVisited, "host": _HostVisited}


def checkpoint_ident(model: Model, visited_backend: str, check_invariants: bool,
                     check_deadlock: bool) -> str:
    """The identity stamped into each checkpoint, byte for byte the JAX
    package's: a checkpoint resumes only the same model, constants,
    backend, invariant selection and deadlock setting (a resume never
    re-checks the levels already explored)."""
    spec = model.spec
    inv_names = ",".join(sorted(i.name for i in model.invariants)) if check_invariants else "-"
    return (
        f"{model.name}|lanes={spec.num_lanes}|backend={visited_backend}|"
        f"inv={inv_names}|dl={check_deadlock}|"
        + ",".join(f"{f.name}:{f.shape}:{f.lo}:{f.hi}" for f in spec.fields)
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
    that verifies when one is there.  A checkpointed run keeps no trace
    (store_trace is forced off): a violation found after a resume reports
    its state with an empty trace.
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
    pipe_name = resolve_pipeline(pipeline)
    dev = resolve_device(device)
    spec = model.spec
    K = spec.num_lanes
    C = model.total_fanout
    t0 = time.perf_counter()
    if checkpoint_dir is not None:
        store_trace = False
        checkpoint_every = max(1, int(checkpoint_every))
    chain = integrity.LevelDigestChain() if integrity.enabled() else None
    pipe = (DevicePipeline(model, visited_backend, check_invariants, check_deadlock,
                           compact_shift, compact_gate)
            if pipe_name == "device" else None)
    collect_stats = stats_path is not None
    stats_levels = []
    visited = None

    inits = [
        {k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in s.items()}
        for s in model.init_states()
    ]
    init_packed = torch.stack([spec.pack(s) for s in inits]).numpy()
    init_packed = torch.from_numpy(np.unique(init_packed, axis=0)).to(dev)
    n0 = init_packed.shape[0]
    levels = [n0]
    total = n0
    none = torch.full((n0,), -1, dtype=torch.int64, device=dev)
    trace_store = [(init_packed, none, none)] if store_trace else []
    if collect_levels is not None:
        collect_levels.append(init_packed)

    def decode_state(packed_row):
        s = {k: v.cpu().numpy() for k, v in spec.unpack(packed_row).items()}
        return model.decode(s) if model.decode else s

    def violation_at(name, depth, idx, frontier):
        """The violation of row `idx` of `frontier`, the level at `depth`."""
        if store_trace:
            return walk_trace(trace_store, model.actions, decode_state, name, depth, idx)
        return Violation(invariant=name, depth=depth, state=decode_state(frontier[idx]), trace=[])

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

    chunk = next_pow2(max(min_bucket, chunk_size))
    frontier = init_packed
    depth = 0
    store = None
    loaded = None
    if checkpoint_dir is not None:
        store = CheckpointStore(
            checkpoint_dir, CHECKPOINT_BASENAME,
            ident=checkpoint_ident(model, visited_backend, check_invariants, check_deadlock),
            keep=checkpoint_keep,
            # a generation whose chain does not verify falls back like a
            # checksum failure
            validators=(integrity.checkpoint_chain_errors,) if chain is not None else (),
        )
        loaded = store.load()
    if loaded is not None:
        snap, _gen = loaded
        visited = _RESUMES[visited_backend].resume(snap, dev)
        frontier = from_u32(snap["frontier"], dev)
        levels = snap["levels"].tolist()
        total = int(snap["total"])
        depth = int(snap["depth"])
        if chain is not None:
            # a resumed run extends the stamped chain; a file without one
            # gives an unanchored chain (counts only)
            chain = (integrity.LevelDigestChain.from_array(snap["digest_chain"])
                     if "digest_chain" in snap else integrity.LevelDigestChain.from_levels(levels))
    else:
        hi0, lo0 = fp_stage(spec, init_packed)
        if visited_backend == "device":
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
        extra = visited.save_arrays()
        stamp = {}
        if chain is not None and chain.anchored:
            # the dump must digest to the chain's running total before it
            # is written: corruption found here never enters a checkpoint
            chain.verify_visited(integrity.visited_fps(extra), depth=depth)
            stamp = {"digest_chain": chain.to_array()}
        store.save(depth, dict(frontier=to_u32(frontier), vcap=visited.capacity,
                               levels=np.asarray(levels), total=total, **extra, **stamp))

    violation = None
    while frontier.shape[0] > 0:
        if chain is not None and chain.anchored and depth < len(chain.entries):
            # the frontier about to be expanded must digest to the entry
            # sealed when its level was found (or loaded from a checkpoint)
            chain.verify_level(depth, fps_u64(*fp_stage(spec, frontier)))
        if max_depth is not None and depth >= max_depth:
            break
        if max_states is not None and total >= max_states:
            break
        f_total = frontier.shape[0]
        t_level = time.perf_counter()
        step_s = host_s = 0.0
        act_en = torch.zeros(len(model.actions), dtype=torch.int64, device=dev) if collect_stats \
            else None
        lvl_rows, lvl_parent, lvl_act = [], [], []
        lvl_new = 0
        verdict = None  # (frontier index, invariant name)
        dev_handled = 0
        plan = pipe.plan_level(f_total, chunk, min_bucket) if pipe is not None else None
        if plan is not None:
            # the device-resident span: every gated chunk queued on the
            # card, one host read; a sub-gate tail chunk follows below at
            # its serial offset
            t_step = time.perf_counter()
            out = pipe.run_level(frontier, plan, visited)
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
                    # the deferred probe: one batched insert of the level's
                    # novel candidates, in candidate order
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
                    lvl_rows.append(rows)
                    lvl_parent.append(parent)
                    lvl_act.append(act)
            host_s += time.perf_counter() - t_host
        for start in range(dev_handled, f_total, chunk):
            t_step = time.perf_counter()
            piece = frontier[start : start + chunk]
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
                lvl_new += win.shape[0]
                lvl_rows.append(out.rows[win])
                lvl_parent.append(out.parent[win] + start)
                lvl_act.append(out.act[win])
            host_s += time.perf_counter() - t_host

        if verdict is not None:
            idx, name = verdict
            violation = violation_at(name, depth, idx, frontier)
            break

        if lvl_rows:
            next_frontier = torch.cat(lvl_rows)
            level_parent = torch.cat(lvl_parent)
            level_act = torch.cat(lvl_act)
        else:
            next_frontier = torch.empty((0, K), dtype=torch.int64, device=dev)
            level_parent = level_act = torch.empty(0, dtype=torch.int64, device=dev)
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
            collect_levels.append(next_frontier)
        if store_trace:
            trace_store.append((next_frontier, level_parent, level_act))
        if progress:
            progress(depth, lvl_new, total)
        frontier = next_frontier
        if store is not None and depth % checkpoint_every == 0:
            save_checkpoint()

    if violation is None and check_invariants and frontier.shape[0]:
        # the loop was cut (max_depth/max_states) before the remaining
        # frontier was expanded: its states still need their invariant pass
        bad = invariant_stage(model, spec.unpack(frontier))
        if bad is not None:
            violation = violation_at(bad[0], depth, bad[1], frontier)
    return finish(violation)
