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

So the two backends reach the same states level by level, in other orders,
and may report other traces; each gives the JAX package's result for the
same knobs: the same level counts, level rows in the same order, the same
first violation and trace.  The JAX package's rules are followed: inits
deduped as ``np.unique(axis=0)``; a chunk is
``next_pow2(max(min_bucket, chunk_size))`` frontier rows, padded in the JAX
package to the bucket ``next_pow2(max(rows, min_bucket))`` that selects
the candidate order; the sorted set starts at
``next_pow2(max(n0, min_bucket * C, 2))`` entries and grows to the next
power of two before any chunk with ``n + bucket * C`` over its capacity;
the table starts from ``table_from_pairs`` with at least
``_HASH_MIN_CAP`` slots and doubles before any chunk that finds it over
half full, and a probe overflow doubles it and re-runs the same batch,
OR-ing novelty; the first violation is the first invariant in model order
at the first row of the first chunk, then a deadlock.  Everything stays on
``device``; the host reads counts, flags and the violation's index.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.base import Model
from ..ops import dedup, hashset
from ..ops.cuda_hashset import probe_insert
from ..pipeline_registry import resolve_pipeline
from .pipeline import (compacts, fp_stage, grow_visited, invariant_stage, next_pow2, run_chunk,
                       sorted_dedup_stage)

# device-hash table floor (module-level so tests can shrink it to exercise
# the growth and overflow-re-run paths at small state counts)
_HASH_MIN_CAP = 1 << 16
VISITED_BACKENDS = ("device", "device-hash")


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


class _SortedVisited:
    """The ``device`` backend: sorted order keys, padded to a power of two."""

    def __init__(self, hi0, lo0, cap: int):
        keys = torch.sort(dedup.order_key(hi0, lo0)).values
        self.n = keys.shape[0]
        self.keys = grow_visited(keys, cap)

    def reserve(self, width: int):
        """Room for a chunk of up to `width` new keys."""
        if self.n + width > self.keys.shape[0]:
            self.keys = grow_visited(self.keys, self.n + width)

    def insert(self, hi, lo) -> torch.Tensor:
        """-> candidate indices of the new states, in fingerprint order."""
        winners, self.keys, self.n = sorted_dedup_stage(dedup.order_key(hi, lo), self.keys, self.n)
        return winners

    def stats(self) -> dict:
        return {"visited_capacity": int(self.keys.shape[0])}


class _HashVisited:
    """The ``device-hash`` backend: the open-addressing table (kernel K2)."""

    def __init__(self, hi0, lo0):
        self.table = hashset.table_from_pairs(hi0, lo0, min_cap=_HASH_MIN_CAP)
        self.n = hi0.shape[0]

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

    def stats(self) -> dict:
        return {"hash_table_capacity": int(self.table.shape[0]), "hash_table_size": self.n}


def check(
    model: Model,
    max_depth: Optional[int] = None,
    min_bucket: int = 256,
    check_deadlock: bool = False,
    visited_backend: str = "device",
    chunk_size: int = 32768,
    compact_shift: int = 2,
    compact_gate: int = 4096,
    pipeline: Optional[str] = None,
    device=None,
    collect_levels: Optional[list] = None,
) -> CheckResult:
    """Breadth-first exhaustive check of `model`; stops at the first
    violation, whose trace is always kept.  Arguments mean what they mean
    for the JAX engine's check(), with its defaults.

    device: where the check runs; None is the card ("cuda"), which raises
    when CUDA is absent.  Pass "cpu" to run the plain versions of the
    kernels on the CPU.
    visited_backend: "device" (sorted set) or "device-hash" (hash table);
    "host" is not ported yet.
    pipeline: "fused" or "legacy" (None: $KSPEC_PIPELINE, else "fused");
    both run the same stages.  compact_shift/compact_gate select the
    candidate order of a chunk (``pipeline.compacts``).
    check_deadlock: report a reachable state with no enabled action as a
    violation of the pseudo-invariant "Deadlock".
    collect_levels: optional list that receives each non-empty level's
    packed rows, int64[n, K], in discovery order.
    """
    if visited_backend not in VISITED_BACKENDS:
        raise ValueError(
            f"visited_backend {visited_backend!r} is not ported to PyTorch yet "
            f"(ported: {', '.join(VISITED_BACKENDS)})"
        )
    pipe_name = resolve_pipeline(pipeline)
    dev = resolve_device(device)
    spec = model.spec
    K = spec.num_lanes
    C = model.total_fanout
    t0 = time.perf_counter()

    inits = [
        {k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in s.items()}
        for s in model.init_states()
    ]
    init_packed = torch.stack([spec.pack(s) for s in inits]).numpy()
    init_packed = torch.from_numpy(np.unique(init_packed, axis=0)).to(dev)
    n0 = init_packed.shape[0]

    hi0, lo0 = fp_stage(spec, init_packed)
    if visited_backend == "device":
        visited = _SortedVisited(hi0, lo0, next_pow2(max(n0, min_bucket * C, 2)))
    else:
        visited = _HashVisited(hi0, lo0)

    levels = [n0]
    total = n0
    none = torch.full((n0,), -1, dtype=torch.int64, device=dev)
    trace_store = [(init_packed, none, none)]
    if collect_levels is not None:
        collect_levels.append(init_packed)

    def decode_state(packed_row):
        s = {k: v.cpu().numpy() for k, v in spec.unpack(packed_row).items()}
        return model.decode(s) if model.decode else s

    def violation_at(name, depth, idx):
        return walk_trace(trace_store, model.actions, decode_state, name, depth, idx)

    def finish(violation):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        return CheckResult(
            model=model.name,
            levels=levels,
            total=total,
            diameter=len(levels) - 1,
            violation=violation,
            seconds=dt,
            states_per_sec=total / max(dt, 1e-9),
            stats={
                "device": str(dev),
                "visited_backend": visited_backend,
                "pipeline": pipe_name,
                "fanout": C,
                "lanes": K,
                **visited.stats(),
            },
        )

    # invariants on the init states
    bad = invariant_stage(model, spec.unpack(init_packed))
    if bad is not None:
        return finish(violation_at(bad[0], 0, bad[1]))

    chunk = next_pow2(max(min_bucket, chunk_size))
    frontier = init_packed
    depth = 0
    violation = None
    while frontier.shape[0] > 0:
        if max_depth is not None and depth >= max_depth:
            break
        lvl_rows, lvl_parent, lvl_act = [], [], []
        lvl_new = 0
        verdict = None  # (frontier index, invariant name)
        for start in range(0, frontier.shape[0], chunk):
            piece = frontier[start : start + chunk]
            bucket = next_pow2(max(piece.shape[0], min_bucket))
            visited.reserve(bucket * C)
            out = run_chunk(model, piece, compacts(bucket, compact_shift, compact_gate),
                            check_deadlock)
            if out.verdict is not None:
                verdict = (start + out.verdict[0], out.verdict[1])
                break
            if out.rows.shape[0] == 0:
                continue
            win = visited.insert(out.hi, out.lo)
            lvl_new += win.shape[0]
            lvl_rows.append(out.rows[win])
            lvl_parent.append(out.parent[win] + start)
            lvl_act.append(out.act[win])

        if verdict is not None:
            idx, name = verdict
            violation = violation_at(name, depth, idx)
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
            if collect_levels is not None:
                collect_levels.append(next_frontier)
        trace_store.append((next_frontier, level_parent, level_act))
        frontier = next_frontier

    if violation is None and frontier.shape[0]:
        # the loop was cut (max_depth) before the remaining frontier was
        # expanded: its states still need their invariant pass
        bad = invariant_stage(model, spec.unpack(frontier))
        if bad is not None:
            violation = violation_at(bad[0], depth, bad[1])
    return finish(violation)
