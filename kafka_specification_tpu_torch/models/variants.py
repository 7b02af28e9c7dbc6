"""Spec variants over the KafkaReplication core (PyTorch).

Counterpart of ``kafka_specification_tpu/models/variants.py``: each variant
is the same nine `Next` disjuncts, differing only in the become-follower
truncation offset (KafkaReplication.tla:274-277):

- KafkaTruncateToHighWatermark: truncate to own HW (known unsafe);
- Kip101: epoch-based truncation via the OffsetsForLeaderEpoch lookup;
- Kip279: tail-matching truncation.

Invariant selection mirrors TLC's .cfg INVARIANT list.  ``make_oracle``
is each variant's set-semantics twin (the reference interpreter's model).
"""

from __future__ import annotations

from typing import Sequence

from ..oracle.interp import OracleModel
from . import kafka_replication as kr
from .base import Model

DEFAULT_INVARIANTS = ("TypeOk", "LeaderInIsr", "WeakIsr", "StrongIsr")

_INVARIANTS = {
    "TypeOk": kr.type_ok,
    "LeaderInIsr": kr.leader_in_isr,
    "LeaderInIsrLiteral": kr.leader_in_isr_literal,
    "WeakIsr": kr.weak_isr,
    "StrongIsr": kr.strong_isr,
}

_VARIANTS = {
    # name -> (truncation offset, name of the become-follower action)
    "KafkaTruncateToHighWatermark": (
        kr.truncate_to_hw_offset,
        "BecomeFollowerTruncateToHighWatermark",
    ),
    "Kip101": (kr.kip101_offset, "BecomeFollowerTruncateKip101"),
    "Kip279": (kr.kip279_offset, "BecomeFollowerTruncateKip279"),
}


_ORACLE_INVARIANTS = {
    "TypeOk": kr.o_type_ok,
    "LeaderInIsr": kr.o_leader_in_isr,
    "LeaderInIsrLiteral": kr.o_leader_in_isr_literal,
    "WeakIsr": kr.o_weak_isr,
    "StrongIsr": kr.o_strong_isr,
}

# the oracle's truncation offset of each variant
_ORACLE_OFFSETS = {
    "KafkaTruncateToHighWatermark": kr.o_truncate_to_hw_offset,
    "Kip101": kr.o_kip101_offset,
    "Kip279": kr.o_kip279_offset,
}


def invariant_kernels(cfg, names):
    return [_INVARIANTS[n](cfg) for n in names]


def _invariant_oracles(cfg, names):
    return [_ORACLE_INVARIANTS[n](cfg) for n in names]


def make_model(
    variant: str, cfg: kr.Config, invariants: Sequence[str] = DEFAULT_INVARIANTS
) -> Model:
    trunc_fn, action_name = _VARIANTS[variant]
    actions = [
        kr.controller_elect_leader(cfg),
        kr.controller_shrink_isr(cfg),
        kr.become_leader(cfg),
        kr.leader_expand_isr(cfg),
        kr.leader_shrink_isr(cfg),
        kr.leader_write(cfg),
        kr.leader_inc_high_watermark(cfg),
        kr.become_follower_and_truncate_to(cfg, action_name, trunc_fn(cfg)),
        kr.follower_replicate(cfg),
    ]
    return Model(
        name=f"{variant}({cfg.n}r,L{cfg.l},R{cfg.r},E{cfg.e})",
        spec=kr.make_spec(cfg),
        init_states=lambda: [kr.init_state(cfg)],
        actions=actions,
        invariants=invariant_kernels(cfg, invariants),
        decode=kr.make_decode(cfg),
        meta={"variant": variant, "cfg": cfg},
    )


def make_oracle(
    variant: str, cfg: kr.Config, invariants: Sequence[str] = DEFAULT_INVARIANTS
) -> OracleModel:
    _, action_name = _VARIANTS[variant]
    actions = [
        kr.o_controller_elect_leader(cfg),
        kr.o_controller_shrink_isr(cfg),
        kr.o_become_leader(cfg),
        kr.o_leader_expand_isr(cfg),
        kr.o_leader_shrink_isr(cfg),
        kr.o_leader_write(cfg),
        kr.o_leader_inc_high_watermark(cfg),
        kr.o_become_follower_and_truncate_to(cfg, action_name, _ORACLE_OFFSETS[variant]),
        kr.o_follower_replicate(cfg),
    ]
    return OracleModel(
        name=f"{variant}-oracle",
        init_states=lambda: [kr.o_init(cfg)],
        actions=actions,
        invariants=_invariant_oracles(cfg, invariants),
        meta={"variant": variant, "cfg": cfg},
    )
