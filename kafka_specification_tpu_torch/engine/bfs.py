"""Single-device level-synchronous BFS model checker (PyTorch).

Counterpart of ``kafka_specification_tpu/engine/bfs.py::check`` with the
``device-hash`` visited set and the legacy full-lattice step
(``pipeline="legacy", compact_shift=0``).  Per chunk of the frontier:

  unpack lanes -> every action kernel on every (state, choice) cell
  -> candidates in state-major, choice-minor order (actions in model order)
  -> fingerprints over the whole lattice, invalid cells masked (kernel K1
     in hashed mode) -> the enabled candidates compacted, in that order
  -> insert-or-find into the open-addressing table (kernel K2): the
     lowest-index copy of each fingerprint not yet visited is new;
  invariants are checked on the frontier chunk being expanded.

This is what the JAX engine's legacy step does for the device-hash backend
(its host-dedup branch: no sort; the table does all the dedup), so both
packages give the same level counts, the same level order, the same first
violation and the same trace: inits deduped as ``np.unique(axis=0)``; a
chunk is ``next_pow2(max(min_bucket, chunk_size))`` frontier rows (the JAX
engine pads it to a power-of-two bucket with invalid rows, which add no
candidate); the table starts from ``table_from_pairs`` with at least
``_HASH_MIN_CAP`` slots and doubles before any chunk that finds it over
half full; a probe overflow doubles it and re-runs the same batch, OR-ing
novelty; the first violation is the first invariant in model order at the
first row of the chunk.  Everything stays on ``device``; the host reads
only counts and flags.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.base import Model
from ..ops import dedup, hashset
from ..ops.cuda_fingerprint import fingerprint
from ..ops.cuda_hashset import probe_insert
from ..ops.fingerprint import fingerprint_lanes

# device-hash table floor (module-level so tests can shrink it to exercise
# the growth and overflow-re-run paths at small state counts)
_HASH_MIN_CAP = 1 << 16


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


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


class _Step:
    """One chunk of the level: invariants, expansion, fingerprints."""

    def __init__(self, model: Model, device: torch.device):
        self.model = model
        self.spec = model.spec
        self.C = model.total_fanout
        self.act_ids = torch.cat(
            [
                torch.full((a.n_choices,), i, dtype=torch.int64)
                for i, a in enumerate(model.actions)
            ]
        ).to(device)

    def fingerprints(self, lanes, valid):
        """Masked (hi, lo): the sentinel pair for invalid rows."""
        if self.spec.exact64:
            hi, lo = fingerprint_lanes(lanes, exact=True)
            return torch.where(valid, hi, dedup.SENT), torch.where(valid, lo, dedup.SENT)
        return fingerprint(lanes, valid)

    def invariants(self, states):
        """First violated invariant on the chunk in model order, as
        (name, first row) or None."""
        for inv in self.model.invariants:
            bad = ~inv.pred(states)
            if bool(bad.any()):
                return inv.name, int(torch.argmax(bad.to(torch.uint8)))
        return None

    def expand(self, piece):
        """frontier rows int64[B, K] -> (states, enabled[B, C], cand[B*C, K])."""
        states = self.spec.unpack(piece)
        en_parts, packed_parts = [], []
        for a in self.model.actions:
            en, nxt = a.kernel(states)
            en_parts.append(en)
            packed_parts.append(self.spec.pack(nxt))
        en = torch.cat(en_parts, dim=1)
        cand = torch.cat(packed_parts, dim=1).reshape(-1, self.spec.num_lanes)
        return states, en, cand

    def candidates(self, en, cand):
        """-> (rows, parent, act, keys) of every enabled candidate, in
        candidate order, in-batch duplicates included: the table's
        lowest-index-wins rule picks which copy is new."""
        valid = en.reshape(-1)
        hi, lo = self.fingerprints(cand, valid)
        sel = valid.nonzero().squeeze(1)
        keys = dedup.pair_key(hi[sel], lo[sel])
        return cand[sel], sel // self.C, self.act_ids[sel % self.C], keys


def check(
    model: Model,
    max_depth: Optional[int] = None,
    min_bucket: int = 256,
    check_deadlock: bool = False,
    visited_backend: str = "device-hash",
    chunk_size: int = 32768,
    device=None,
    collect_levels: Optional[list] = None,
) -> CheckResult:
    """Breadth-first exhaustive check of `model`; stops at the first
    violation, whose trace is always kept.  Arguments mean what they mean
    for the JAX engine's check().

    device: where the check runs; None is the card ("cuda"), which raises
    when CUDA is absent.  Pass "cpu" to run the plain versions of the
    kernels on the CPU.
    visited_backend: only "device-hash" is ported.
    check_deadlock: report a reachable state with no enabled action as a
    violation of the pseudo-invariant "Deadlock".
    collect_levels: optional list that receives each non-empty level's
    packed rows, int64[n, K], in discovery order.
    """
    if visited_backend != "device-hash":
        raise ValueError(
            f"visited_backend {visited_backend!r} is not ported to PyTorch yet "
            "(ported: 'device-hash')"
        )
    dev = resolve_device(device)
    spec = model.spec
    K = spec.num_lanes
    step = _Step(model, dev)
    t0 = time.perf_counter()

    inits = [
        {k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in s.items()}
        for s in model.init_states()
    ]
    init_packed = torch.stack([spec.pack(s) for s in inits]).numpy()
    init_packed = torch.from_numpy(np.unique(init_packed, axis=0)).to(dev)
    n0 = init_packed.shape[0]

    hi0, lo0 = step.fingerprints(
        init_packed, torch.ones(n0, dtype=torch.bool, device=dev)
    )
    table = hashset.table_from_pairs(hi0, lo0, min_cap=_HASH_MIN_CAP)
    hash_n = n0

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
                "fanout": step.C,
                "lanes": K,
                "hash_table_capacity": int(table.shape[0]),
                "hash_table_size": hash_n,
            },
        )

    # invariants on the init states
    bad = step.invariants(spec.unpack(init_packed))
    if bad is not None:
        return finish(violation_at(bad[0], 0, bad[1]))

    chunk = _next_pow2(max(min_bucket, chunk_size))
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
            if 2 * hash_n > table.shape[0]:
                # keep the load factor under 1/2 so probe chains stay short
                table = hashset.rehash_into(table, 2 * table.shape[0])
            states, en, cand = step.expand(piece)
            bad = step.invariants(states)
            if bad is not None:
                verdict = (start + bad[1], bad[0])
                break
            if check_deadlock:
                dead = ~en.any(dim=1)
                if bool(dead.any()):
                    verdict = (start + int(torch.argmax(dead.to(torch.uint8))), "Deadlock")
                    break
            rows, parent, act, keys = step.candidates(en, cand)
            if keys.shape[0] == 0:
                continue
            isnew, n_new = None, 0
            while True:
                # n and ovf come to the host in one read
                table, is_new, n, ovf = probe_insert(table, keys)
                isnew = is_new if isnew is None else isnew | is_new
                n_new += n
                if not ovf:
                    break
                # rows the failed attempt inserted (and counted) report
                # "seen" on the re-run; OR-ing keeps them new, so nothing is
                # lost or counted twice
                table = hashset.rehash_into(table, 2 * table.shape[0])
            hash_n += n_new
            lvl_new += n_new
            lvl_rows.append(rows[isnew])
            lvl_parent.append(parent[isnew] + start)
            lvl_act.append(act[isnew])

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
        bad = step.invariants(spec.unpack(frontier))
        if bad is not None:
            violation = violation_at(bad[0], depth, bad[1])
    return finish(violation)
