"""The partition product: K independent partitions of base models as one.

Counterpart of ``kafka_specification_tpu/models/product.py``, with its
oracle twin (``product_oracle``).  The reference specs model one partition; the product reads
"5 brokers / 3 partitions" as K independent instances interleaved: `Next`
is the disjoint union of the per-partition actions (one partition steps at
a time), the invariants are the conjunction over partitions, and so is
the constraint, over the bases that have one.  The reachable set is
|base|^K; a product state's BFS depth is the sum of its partitions'
depths, so the level counts are the convolution of the bases' levels.

Encoding: each base field is repeated with a partition prefix,
``p{p}.{name}``, in partition order, so both packages pack a product state
to the same lanes.  Actions are ``p{p}.{name}``, each a base kernel lifted
by slicing its partition's fields in and out; in the batched form the
other partitions' fields are broadcast to [B, n, ...] (views, no copies).
"""

from __future__ import annotations

import itertools

from ..ops.packing import Field, StateSpec
from ..oracle.interp import OracleAction, OracleModel
from .base import Action, Invariant, Model


def product_model(base: Model, k: int, name: str | None = None) -> Model:
    """K independent copies of `base` interleaved as one model."""
    assert k >= 1
    return product_models(
        [base] * k,
        name=name or f"{base.name} x{k}partitions",
        meta={**base.meta, "partitions": k, "base": base.name},
    )


def _and(parts):
    ok = None
    for r in parts:
        ok = r if ok is None else ok & r
    return ok


def product_models(bases, name: str | None = None, meta: dict | None = None) -> Model:
    """Product of partitions with bases that may differ (their specs and
    fanouts); the invariant NAMES must agree across bases."""
    assert bases
    specs = [b.spec for b in bases]
    k = len(bases)
    spec = StateSpec(
        [Field(f"p{p}.{f.name}", f.shape, f.lo, f.hi) for p, bs in enumerate(specs) for f in bs.fields]
    )

    def split(state, p):
        return {f.name: state[f"p{p}.{f.name}"] for f in specs[p].fields}

    def init_states():
        # the cross product of the per-partition init sets
        outs = []
        for combo in itertools.product(*[b.init_states() for b in bases]):
            outs.append({f"p{p}.{key}": v for p, binit in enumerate(combo) for key, v in binit.items()})
        return outs

    def lift(p, a):
        def kernel(state):
            en, nxt = a.kernel(split(state, p))
            b, n = en.shape
            out = {key: v.unsqueeze(1).expand(b, n, *v.shape[1:]) for key, v in state.items()}
            out.update({f"p{p}.{key}": v for key, v in nxt.items()})
            return en, out

        writes = frozenset(f"p{p}.{w}" for w in a.writes) if a.writes is not None else None
        return Action(f"p{p}.{a.name}", a.n_choices, kernel, writes=writes)

    actions = [lift(p, a) for p, b in enumerate(bases) for a in b.actions]

    inv_names = [i.name for i in bases[0].invariants]
    for b in bases[1:]:
        assert [i.name for i in b.invariants] == inv_names, (
            "product bases must agree on invariant selection: "
            f"{inv_names} vs {[i.name for i in b.invariants]}"
        )

    def conj(i_idx):
        def pred(state):
            return _and(b.invariants[i_idx].pred(split(state, p)) for p, b in enumerate(bases))

        return pred

    invariants = [Invariant(n, conj(i)) for i, n in enumerate(inv_names)]

    constraint = None
    if any(b.constraint is not None for b in bases):
        def constraint(state):
            return _and(b.constraint(split(state, p)) for p, b in enumerate(bases)
                        if b.constraint is not None)

    decode = None
    if all(b.decode is not None for b in bases):
        def decode(s):
            return tuple(bases[p].decode(split(s, p)) for p in range(k))

    return Model(
        name=name or " x ".join(b.name for b in bases),
        spec=spec,
        init_states=init_states,
        actions=actions,
        invariants=invariants,
        constraint=constraint,
        decode=decode,
        meta=meta or {**bases[0].meta, "partitions": k, "base": [b.name for b in bases]},
    )


def product_oracle(base: OracleModel, k: int) -> OracleModel:
    """Oracle twin of product_model: state = k-tuple of base states; each
    action steps one partition.  Canonical form matches product_model's
    decode (a tuple of per-partition decodes)."""
    assert k >= 1

    def init():
        import itertools

        return [tuple(c) for c in itertools.product(base.init_states(), repeat=k)]

    actions = []
    for p in range(k):
        for a in base.actions:
            def succ(s, p=p, a=a):
                for t in a.successors(s[p]):
                    yield s[:p] + (t,) + s[p + 1 :]

            actions.append(OracleAction(f"p{p}.{a.name}", succ))

    invariants = [
        (name, lambda s, pred=pred: all(pred(x) for x in s))
        for name, pred in base.invariants
    ]
    constraint = None
    if base.constraint is not None:
        def constraint(s):
            return all(base.constraint(x) for x in s)

    return OracleModel(
        name=f"{base.name} x{k}partitions",
        init_states=init,
        actions=actions,
        invariants=invariants,
        constraint=constraint,
        meta={**base.meta, "partitions": k, "base": base.name},
    )
