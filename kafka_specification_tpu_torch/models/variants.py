"""Spec variants over the KafkaReplication core (PyTorch).

Counterpart of ``kafka_specification_tpu/models/variants.py``: each variant
is the same nine `Next` disjuncts, differing only in the become-follower
truncation offset (KafkaReplication.tla:274-277):

- KafkaTruncateToHighWatermark: truncate to own HW (known unsafe);
- Kip101: epoch-based truncation via the OffsetsForLeaderEpoch lookup;
- Kip279: tail-matching truncation.

Invariant selection mirrors TLC's .cfg INVARIANT list.
"""

from __future__ import annotations

from typing import Sequence

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


def invariant_kernels(cfg, names):
    return [_INVARIANTS[n](cfg) for n in names]


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
