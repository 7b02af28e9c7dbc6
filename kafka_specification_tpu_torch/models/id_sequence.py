"""IdSequence: a monotonically increasing bounded counter (PyTorch).

Counterpart of ``kafka_specification_tpu/models/id_sequence.py``
(IdSequence.tla: ``NextId(id) == id <= MaxId /\\ id = nextId /\\
nextId' = nextId + 1``, ``Next == \\E id \\in 0..MaxId : NextId(id)``,
``TypeOk == nextId \\in 0..MaxId+1``).  The existential is forced (only
id = nextId passes the guard), so the action has one choice.  MaxId + 2
states in one chain.
"""

from __future__ import annotations

from ..ops.packing import Field, StateSpec
from ..oracle.interp import OracleAction, OracleModel
from .base import Action, Invariant, Model


def make_model(max_id: int) -> Model:
    spec = StateSpec([Field("nextId", (), 0, max_id + 1)])

    def next_id(s):
        n = s["nextId"].unsqueeze(1)
        return n <= max_id, {"nextId": (n + 1).clamp(max=max_id + 1)}

    def type_ok(s):
        return (s["nextId"] >= 0) & (s["nextId"] <= max_id + 1)

    return Model(
        name=f"IdSequence(MaxId={max_id})",
        spec=spec,
        init_states=lambda: [{"nextId": 0}],
        actions=[Action("NextId", 1, next_id, writes=frozenset({"nextId"}))],
        invariants=[Invariant("TypeOk", type_ok)],
        decode=lambda s: int(s["nextId"]),
    )


def make_oracle(max_id: int) -> OracleModel:
    def successors(s):
        if s <= max_id:  # IdSequence.tla:31-33
            yield s + 1

    return OracleModel(
        name=f"IdSequence(MaxId={max_id})",
        init_states=lambda: [0],  # IdSequence.tla:37
        actions=[OracleAction("NextId", successors)],
        invariants=[("TypeOk", lambda s: 0 <= s <= max_id + 1)],  # IdSequence.tla:43
    )
