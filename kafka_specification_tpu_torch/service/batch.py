"""Batched multi-config checking: one exploration, N verdicts.

The port's own copy of ``kafka_specification_tpu/service/batch.py``.  N
jobs whose configs share a schema shape (scheduler.group_key: module,
kernel source, constants, constraints) are advanced by ONE engine run: the
per-level successor kernels (and K1) launch once for the whole group
instead of once per job.  Members may differ in invariant selection and in
``max_depth`` / ``max_states``.

How it stays identical to ``cli check`` run solo:

1.  Exploration is invariant-agnostic: successor generation, constraint
    pruning, fingerprinting, dedup and chunking depend only on (model,
    engine knobs), so a solo run differs from the shared run only in
    *stopping earlier*.  The shared run uses the same knobs and explores
    to the envelope of the members' bounds (max of max_depth/max_states,
    unbounded if any member is unbounded), so every member's solo
    exploration is a prefix of the shared one, level for level, row for
    row.
2.  The shared run records everything a verdict needs: each level's rows
    on the card (``collect_levels``), the parent/action trace store
    (``collect_trace``), and per-level counts.
3.  Each member's verdict is then *replayed* against the shared record
    with exactly the solo engine's semantics: the init-state invariant
    pass first; then per level, chunk by chunk (the same
    ``next_pow2(max(min_bucket, chunk_size))`` chunk boundaries), the
    first chunk with a violation wins, the first invariant in the
    member's model order within that chunk, the first row within that
    invariant; ``max_depth``/``max_states`` cut at the same loop points;
    the cut-off run's final frontier gets the solo post-loop invariant
    pass (whole frontier, per-invariant order).  Counterexample traces
    walk the shared trace store through the engine's ``walk_trace``.

The per-(level, invariant) pass runs the model's batched predicate on the
card over the level's rows padded to a power-of-two bucket (at least 32
rows; the padding's answers are dropped), once for the whole group: the
results are kept on the shared exploration, and members share them.  The
JAX package also caches a jitted predicate per (invariant, bucket) on the
model; the port's predicates are plain torch calls, compiled by nothing,
so there is nothing of that kind to keep.

Memory: the shared record holds every level's rows on the card
(``SharedExploration.collected_bytes``), so this runner is for the small
configs a multi-tenant service coalesces.  Singleton groups never come
here: the daemon runs them through the solo engine path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..engine.bfs import CheckResult, PreparedKernels, Violation, check, walk_trace
from ..engine.pipeline import next_pow2


@dataclass
class Member:
    """One job's verdict-relevant view of a shared exploration."""

    job_id: str
    invariants: tuple  # names, in the member's solo model order
    max_depth: Optional[int] = None
    max_states: Optional[int] = None


class SharedExploration:
    """The shared run's record and the lazy per-(level, invariant) pass."""

    def __init__(self, model, result: CheckResult, collected: list,
                 trace: list, chunk: int):
        self.model = model
        self.result = result
        self.levels = result.levels
        self.collected = collected
        self.trace = trace
        self.chunk = chunk
        self._preds = {i.name: i.pred for i in model.invariants}
        self._ok: dict = {}  # (level, name) -> np.bool_ array
        self._viol: dict = {}  # (name, depth, idx) -> Violation

    @property
    def collected_bytes(self) -> int:
        """Bytes of the collected levels' rows, on their device."""
        return sum(int(t.numel()) * t.element_size() for t in self.collected)

    def ok(self, level: int, name: str) -> np.ndarray:
        """Invariant `name` holds per state of `level`: evaluated once per
        (level, name) for the whole group, on the rows' device."""
        key = (level, name)
        if key not in self._ok:
            rows = self.collected[level]
            n = rows.shape[0]
            bucket = next_pow2(max(32, n))
            if bucket != n:
                pad = torch.zeros((bucket - n, rows.shape[1]), dtype=rows.dtype,
                                  device=rows.device)
                rows = torch.cat([rows, pad])
            ok = self._preds[name](self.model.spec.unpack(rows))
            self._ok[key] = ok[:n].cpu().numpy()  # the padding's answers dropped
        return self._ok[key]

    def violation(self, name: str, depth: int, idx: int) -> Violation:
        """Walk the shared trace store once per distinct (invariant, depth,
        row): members tripping the same violation share the trace."""
        key = (name, depth, idx)
        if key not in self._viol:
            self._viol[key] = walk_trace(
                self.trace, self.model.actions, self.decode, name, depth, idx
            )
        return self._viol[key]

    def decode(self, packed_row):
        s = {k: v.cpu().numpy() for k, v in self.model.spec.unpack(packed_row).items()}
        return self.model.decode(s) if self.model.decode else s


def shared_bounds(members: list) -> tuple:
    """Envelope of the members' depth/state bounds (None dominates)."""
    md = None
    if all(m.max_depth is not None for m in members):
        md = max(m.max_depth for m in members)
    ms = None
    if all(m.max_states is not None for m in members):
        ms = max(m.max_states for m in members)
    return md, ms


def pack_members(group: list, max_group: int) -> list:
    """Split one planned group into submit-order packs of at most
    ``max_group`` members: the shared record holds every level of the
    envelope exploration on the card and a group runs at the max of its
    members' bounds, so a wide group is width-capped; contiguous
    submit-order packs keep each pack's envelope near its members' own
    bounds."""
    if max_group <= 0 or len(group) <= max_group:
        return [list(group)]
    return [
        list(group[i:i + max_group])
        for i in range(0, len(group), max_group)
    ]


def explore_shared(
    model,
    members: list,
    prepared: Optional[PreparedKernels] = None,
    min_bucket: int = 256,
    chunk_size: int = 32768,
    visited_backend: str = "device",
    run=None,
    governor=None,
    stats_path: Optional[str] = None,
    device=None,
) -> SharedExploration:
    """One invariant-agnostic engine run covering every member's bounds."""
    md, ms = shared_bounds(members)
    collected: list = []
    trace: list = []
    res = check(
        model,
        max_depth=md,
        max_states=ms,
        store_trace=True,
        min_bucket=min_bucket,
        check_invariants=False,
        collect_levels=collected,
        collect_trace=trace,
        chunk_size=chunk_size,
        visited_backend=visited_backend,
        prepared=prepared,
        run=run,
        governor=governor,
        stats_path=stats_path,
        # the warm path: the visited set at the capacity the last run of
        # this shape ended at (PreparedKernels.capacity_hint)
        visited_capacity_exact=(
            prepared.capacity_hint if prepared is not None else None
        ),
        device=device,
    )
    if prepared is not None:
        prepared.note_result(res)
    return SharedExploration(
        model, res, collected, trace,
        chunk=next_pow2(max(min_bucket, chunk_size)),
    )


def derive_member(shared: SharedExploration, member: Member) -> CheckResult:
    """Replay one member's solo verdict from the shared record (see the
    module docstring for why it equals the solo run)."""
    t0 = time.perf_counter()
    L, C = shared.levels, shared.collected
    model = shared.model
    n0 = L[0]
    levels = [n0]
    total = n0
    violation = None

    def finish(depth: int) -> CheckResult:
        dt = max(time.perf_counter() - t0, 1e-9)
        return CheckResult(
            model=model.name,
            levels=levels,
            total=total,
            diameter=len(levels) - 1,
            violation=violation,
            seconds=shared.result.seconds,
            states_per_sec=total / max(shared.result.seconds, 1e-9),
            stats={"derive_ms": round(dt * 1e3, 2)},
        )

    # the init-state invariant pass (the solo engine's: before the level
    # loop, per invariant in model order, the whole init set)
    for name in member.invariants:
        ok = shared.ok(0, name)
        if not ok.all():
            idx = int(np.argmax(~ok))
            state = shared.decode(C[0][idx])
            violation = Violation(
                invariant=name, depth=0, state=state,
                trace=[("<init>", state)],
            )
            return finish(0)

    depth = 0
    cut = False
    while True:
        n_frontier = C[depth].shape[0] if depth < len(C) else 0
        if n_frontier == 0:
            break
        if member.max_depth is not None and depth >= member.max_depth:
            cut = True
            break
        if member.max_states is not None and total >= member.max_states:
            cut = True
            break
        # mid-level scan: the first chunk (solo chunk boundaries) with a
        # member-invariant violation; in it, the first invariant in the
        # member's model order; for that, the first row
        verdict = None
        for start in range(0, n_frontier, shared.chunk):
            end = min(start + shared.chunk, n_frontier)
            for name in member.invariants:
                bad = ~shared.ok(depth, name)[start:end]
                if bad.any():
                    verdict = (name, start + int(np.argmax(bad)))
                    break
            if verdict is not None:
                break
        if verdict is not None:
            name, idx = verdict
            violation = shared.violation(name, depth, idx)
            break
        if depth + 1 >= len(C):
            # expanding this level produced nothing new: the solo loop's
            # next iteration sees an empty frontier and exits
            break
        depth += 1
        levels.append(L[depth])
        total += L[depth]

    if violation is None and member.invariants and cut \
            and depth < len(C) and C[depth].shape[0]:
        # the solo post-loop pass: the cut left this frontier unexpanded,
        # so its states still owe their invariant check (the whole
        # frontier, per invariant in order, not the chunked rule)
        for name in member.invariants:
            ok = shared.ok(depth, name)
            if not ok.all():
                idx = int(np.argmax(~ok))
                violation = shared.violation(name, depth, idx)
                break
    return finish(depth)


def run_group(
    model,
    members: list,
    prepared: Optional[PreparedKernels] = None,
    **explore_kw,
) -> tuple:
    """Explore once, derive every member.
    -> ({job_id: CheckResult}, SharedExploration)."""
    shared = explore_shared(model, members, prepared=prepared, **explore_kw)
    return {
        m.job_id: derive_member(shared, m) for m in members
    }, shared
