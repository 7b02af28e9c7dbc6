"""Model API: a TLA+ spec compiled to batched PyTorch kernels.

Counterpart of ``kafka_specification_tpu/models/base.py``.  A Model is
(TLA+ module + TLC .cfg) in tensor form:

- `spec` defines the canonical lane encoding of one state;
- each Action is one disjunct of `Next` over a fixed choice space (the
  bounded existentials of the TLA+ action, e.g. ``\\E replica \\in
  Replicas``).  Its kernel takes a batch of states, a dict of
  int64[B, *shape] tensors, and returns ``(enabled bool[B, n_choices],
  next dict of int64[B, n_choices, *shape])``: every choice of every state
  at once, where the JAX kernel is one (state, choice) pair under vmap;
- each Invariant is a predicate kernel, dict of int64[B, ...] -> bool[B]
  (True = the state is fine);
- `constraint`, if set, is TLC's CONSTRAINT over successors: a dict of
  int64[B, n, ...] -> bool[B, n].  A successor that breaks it is pruned
  (not explored, not counted); deadlock is still judged on the kernels'
  own enabled masks, before the constraint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..ops.packing import StateSpec

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


class EncodingUnsound(ValueError):
    """A field table, or an action's writes, the lane packer cannot encode
    soundly.  The machine-readable findings (``analysis.Finding``) of the
    action pass ride on ``.findings``."""

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings = list(findings)


def check_spec_fields(fields, context: str = "") -> None:
    """Raise EncodingUnsound when a field's declared range leaves int32, the
    element range of the JAX package's packer: such values would wrap there,
    so the two packages would not agree on what a state is."""
    prefix = f"{context}: " if context else ""
    errs = [
        f"{prefix}field {f.name!r} declares [{f.lo}, {f.hi}] but the packed "
        f"element range is int32 [{INT32_MIN}, {INT32_MAX}]"
        for f in fields
        if f.lo < INT32_MIN or f.hi > INT32_MAX
    ]
    if errs:
        raise EncodingUnsound("; ".join(errs))


@dataclass(frozen=True)
class Action:
    name: str
    n_choices: int
    kernel: Callable  # states dict[B] -> (enabled[B, n], next dict[B, n])
    # the fields the kernel may change (an upper bound), or None when not
    # declared; the analysis's frame pass proves it writes nothing else
    writes: Optional[frozenset] = None


@dataclass(frozen=True)
class Invariant:
    name: str
    pred: Callable  # states dict[B] -> bool[B]


@dataclass
class Model:
    name: str
    spec: StateSpec
    init_states: Callable[[], Sequence[dict]]
    actions: Sequence[Action]
    invariants: Sequence[Invariant]
    constraint: Optional[Callable] = None  # successors[B, n] -> bool[B, n]
    # canonical Python value for a decoded state (numpy fields in, the JAX
    # package's decoded form out), so traces compare across the packages
    decode: Optional[Callable[[dict], object]] = None
    # what the trace renderer reads (utils/pretty.py): "variant", the
    # module's name, and "replica_names", the .cfg's model values
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        check_spec_fields(self.spec.fields, context=self.name)

    @property
    def total_fanout(self) -> int:
        return sum(a.n_choices for a in self.actions)
