"""The reference interpreter ("the oracle"): plain set semantics.

The port's copy of ``kafka_specification_tpu/oracle/interp.py``.  Each
TLA+ module of the corpus is transcribed into Python set semantics: states
are canonical immutable values, actions are successor generators, and an
explicit BFS gives the distinct-state counts, per-level counts and state
sets, diameters and first violations.  The port's batched action kernels
are held against it level by level, as state *sets* (tests, and
``chip_smoke.py`` phase ``oracle`` on the card).

It deliberately shares no code with the kernel path: pure Python, no
torch, no packing, no kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence


@dataclass(frozen=True)
class OracleAction:
    name: str
    # state -> iterable of successor states (already canonical/immutable)
    successors: Callable[[object], Iterable[object]]


@dataclass
class OracleModel:
    name: str
    init_states: Callable[[], Sequence[object]]
    actions: Sequence[OracleAction]
    invariants: Sequence[tuple[str, Callable[[object], bool]]]
    constraint: Optional[Callable[[object], bool]] = None
    # same vocabulary as Model.meta (drives TLA-style trace rendering)
    meta: dict = field(default_factory=dict)


@dataclass
class OracleResult:
    levels: list[int]
    level_sets: list[set]
    total: int
    diameter: int
    violation: Optional[tuple[str, int, object]]  # (invariant, depth, state)
    trace: list = field(default_factory=list)  # [(action_name, state), ...]

    @property
    def ok(self) -> bool:
        return self.violation is None


def oracle_bfs(
    model: OracleModel,
    max_depth: Optional[int] = None,
    max_states: Optional[int] = None,
    stop_on_violation: bool = True,
    keep_level_sets: bool = True,
    check_deadlock: bool = False,
) -> OracleResult:
    """check_deadlock: report a state with no successors as a violation of
    the pseudo-invariant "Deadlock" (TLC's CHECK_DEADLOCK TRUE).  Note: an
    oracle model whose generators bake constraint bounds into the guards
    (AsyncIsr) treats constraint-pruned successors as absent here."""
    inits = list(dict.fromkeys(model.init_states()))
    visited = set(inits)
    parent = {s: (None, "<init>") for s in inits}
    frontier = inits
    levels = [len(inits)]
    level_sets = [set(inits)] if keep_level_sets else []
    violation = None
    depth = 0

    def check(states, d):
        for name, pred in model.invariants:
            for s in states:
                if not pred(s):
                    return (name, d, s)
        return None

    violation = check(frontier, 0)
    while frontier and violation is None:
        if max_depth is not None and depth >= max_depth:
            break
        if max_states is not None and len(visited) >= max_states:
            break
        nxt = []
        for s in frontier:
            any_succ = False
            for a in model.actions:
                for t in a.successors(s):
                    any_succ = True
                    if model.constraint is not None and not model.constraint(t):
                        continue
                    if t not in visited:
                        visited.add(t)
                        parent[t] = (s, a.name)
                        nxt.append(t)
            if check_deadlock and not any_succ and violation is None:
                violation = ("Deadlock", depth, s)
        if violation is not None and check_deadlock and violation[0] == "Deadlock":
            frontier = []
            break
        depth += 1
        if nxt:
            levels.append(len(nxt))
            if keep_level_sets:
                level_sets.append(set(nxt))
        if stop_on_violation:
            violation = check(nxt, depth)
        frontier = nxt

    trace = []
    if violation is not None:
        s = violation[2]
        while s is not None:
            p, aname = parent[s]
            trace.append((aname, s))
            s = p
        trace.reverse()

    return OracleResult(
        levels=levels,
        level_sets=level_sets,
        total=len(visited),
        diameter=len(levels) - 1,
        violation=violation,
        trace=trace,
    )
