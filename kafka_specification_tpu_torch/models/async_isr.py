"""AsyncIsr: the KIP-497-style AlterIsr model, as batched PyTorch kernels.

Counterpart of ``kafka_specification_tpu/models/async_isr.py``, with its
set-semantics oracle (``o_init``, ``make_oracle``) at the end.  A
fixed leader (replica 0) proposes ISR changes to the controller
asynchronously; the high watermark counts pending ISR members too
(``HighWatermark == Min(offsets over isr \\union pendingIsr)``), and the
invariant is ``ValidHighWatermark``.

The spec as written is unbounded (``LeaderWrite`` has no MaxOffset guard,
controller versions grow), so the bounds MaxOffset and MaxVersion are
guards in the actions: a successor past them is never enabled.  The model
sets no ``Model.constraint``.

Encoding (the same fields in the same order as the JAX package, so states
pack to the same lanes and fingerprints): ``updates`` are keyed by version
(each is written by a CAS to controllerVersion + 1), ``upd_isr[v]`` = -1
when absent; ``requests`` reuse the leader's current version, so they are
a per-version bitset over ISR subsets, ``req_bits[v]`` bit s <=> request
(isr = s, version = v).  That bitset has 2^N bits and must fit one int32
element: N <= 4.

Batching as in ``kafka_replication``: an action kernel takes a dict of
int64[B, *shape] and returns (enabled bool[B, n], next dict of
int64[B, n, *shape]) for every choice at once; the choice spaces are N,
2^N, N, N, 1, V + 1 and N.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.packing import Field, StateSpec
from ..oracle.interp import OracleAction, OracleModel
from .base import INT32_MAX, Action, EncodingUnsound, Invariant, Model
from .kafka_replication import _at, _bit, _member, _out, _put, choices, col

NIL = -1  # AsyncIsr.tla:38
LEADER = 0  # WLOG (Leader \in Replicas)
DEFAULT_INVARIANTS = ("TypeOk", "ValidHighWatermark")


@dataclass(frozen=True)
class AsyncIsrConfig:
    n_replicas: int
    max_offset: int  # CONSTANT MaxOffset, a guard of LeaderWrite here
    max_version: int  # the bound on controller/leader versions

    @property
    def n(self):
        return self.n_replicas

    @property
    def full_isr(self):
        return (1 << self.n_replicas) - 1


def check_encoding_bounds(cfg: AsyncIsrConfig) -> None:
    """The N <= 4 cliff, with the JAX package's message: the per-version
    request bitset has 2^N bits and must fit one signed int32 element.
    The spec-width finding of that bitset rides on the error's
    ``.findings``, as in the JAX package (``cli analyze`` reports it)."""
    # N capped before the shift, as in the JAX package, so a wild N cannot
    # make the probe allocate a huge integer
    hi = (1 << (1 << min(cfg.n, 6))) - 1
    if hi > INT32_MAX:
        from ..analysis.encoding import spec_fits_errors

        probe = Field("req_bits", (cfg.max_version + 1,), 0, hi)
        raise EncodingUnsound(
            f"AsyncIsr supports at most 4 replicas, got {cfg.n_replicas}: "
            "the request set is encoded as a per-version 2^N-bit subset "
            "bitset (req_bits) that must fit one signed int32 element "
            f"(2^{cfg.n_replicas} bits > 31); "
            "reduce the replica count or extend the encoding to multiple "
            "lanes",
            findings=spec_fits_errors([probe], context="AsyncIsr"),
        )


def make_spec(cfg: AsyncIsrConfig) -> StateSpec:
    N, M, V = cfg.n, cfg.max_offset, cfg.max_version
    check_encoding_bounds(cfg)
    return StateSpec(
        [
            Field("c_isr", (), 0, cfg.full_isr),
            Field("c_ver", (), 0, V),
            Field("l_isr", (), 0, cfg.full_isr),
            Field("l_ver", (), 0, V),
            Field("l_pend", (), 0, cfg.full_isr),
            Field("l_pver", (), NIL, V),
            Field("offs", (N,), 0, M),
            Field("upd_isr", (V + 1,), -1, cfg.full_isr),
            Field("req_bits", (V + 1,), 0, (1 << (1 << N)) - 1),
        ]
    )


def init_state(cfg: AsyncIsrConfig) -> dict:
    """Init (AsyncIsr.tla:137-150)."""
    return {
        "c_isr": cfg.full_isr,
        "c_ver": 0,
        "l_isr": cfg.full_isr,
        "l_ver": 0,
        "l_pend": 0,
        "l_pver": NIL,
        "offs": [0] * cfg.n,
        "upd_isr": [-1] * (cfg.max_version + 1),
        "req_bits": [0] * (cfg.max_version + 1),
    }


def _members(cfg, mask):
    """bool[..., N]: replica r is in the bitmask."""
    ar = torch.arange(cfg.n, device=mask.device)
    return ((mask.unsqueeze(-1) >> ar) & 1) == 1


def _hw(cfg, s):
    """HighWatermark (:58-60) of each state, int64[B]: the least offset over
    l_isr | l_pend (never empty: it always holds the leader); max_offset + 1
    fills the non-members."""
    members = _members(cfg, s["l_isr"] | s["l_pend"])
    return torch.where(members, s["offs"], cfg.max_offset + 1).min(dim=-1).values


def _request(s, l_ver, isr):
    """The leader's request (isr, l_ver) added to req_bits, with pendingIsr
    growing by union (:92-97, :107-112)."""
    cur = _at(s["req_bits"], l_ver)
    return {
        "req_bits": _put(s["req_bits"], cur | (torch.ones_like(isr) << isr), l_ver),
        "l_pend": col(s, "l_pend") | isr,
        "l_pver": l_ver,
    }


def controller_shrink_isr(cfg: AsyncIsrConfig):
    # ControllerShrinkIsr (:72-79), choice = replica
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        c_isr, c_ver = col(s, "c_isr"), col(s, "c_ver")
        enabled = (r != LEADER) & _member(c_isr, r) & (c_ver < cfg.max_version)
        ver = (c_ver + 1).clamp(max=cfg.max_version)
        isr = c_isr & ~_bit(r)
        return _out(s, n, enabled, {
            "c_isr": isr, "c_ver": ver, "upd_isr": _put(s["upd_isr"], isr, ver),
        })

    return Action("ControllerShrinkIsr", n, kernel,
                  writes=frozenset({"c_isr", "c_ver", "upd_isr"}))


def controller_handle_request(cfg: AsyncIsrConfig):
    # ControllerHandleRequest (:81-86), choice = the request's ISR subset
    n = 1 << cfg.n

    def kernel(s):
        subset = choices(s, n)
        c_ver = col(s, "c_ver")
        pending = _member(_at(s["req_bits"], c_ver), subset)
        enabled = pending & (c_ver < cfg.max_version)
        ver = (c_ver + 1).clamp(max=cfg.max_version)
        return _out(s, n, enabled, {
            "c_isr": subset, "c_ver": ver, "upd_isr": _put(s["upd_isr"], subset, ver),
        })

    return Action("ControllerHandleRequest", n, kernel,
                  writes=frozenset({"c_isr", "c_ver", "upd_isr"}))


def leader_request_shrink_isr(cfg: AsyncIsrConfig):
    # LeaderRequestShrinkIsr (:88-100), choice = replica
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        l_isr = col(s, "l_isr")
        enabled = (r != LEADER) & _member(l_isr, r)
        return _out(s, n, enabled, _request(s, col(s, "l_ver"), l_isr & ~_bit(r)))

    return Action("LeaderRequestShrinkIsr", n, kernel,
                  writes=frozenset({"req_bits", "l_pend", "l_pver"}))


def leader_request_expand_isr(cfg: AsyncIsrConfig):
    # LeaderRequestExpandIsr (:102-115): the candidate has reached the HW
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        l_isr = col(s, "l_isr")
        enabled = ~_member(l_isr, r) & (_at(s["offs"], r) >= _hw(cfg, s).unsqueeze(1))
        return _out(s, n, enabled, _request(s, col(s, "l_ver"), l_isr | _bit(r)))

    return Action("LeaderRequestExpandIsr", n, kernel,
                  writes=frozenset({"req_bits", "l_pend", "l_pver"}))


def leader_write(cfg: AsyncIsrConfig):
    # LeaderWrite (:117-119), bounded by MaxOffset
    def kernel(s):
        o = s["offs"][:, LEADER : LEADER + 1]
        return _out(s, 1, o < cfg.max_offset, {
            "offs": _put(s["offs"], (o + 1).clamp(max=cfg.max_offset), torch.full_like(o, LEADER)),
        })

    return Action("LeaderWrite", 1, kernel, writes=frozenset({"offs"}))


def leader_handle_update(cfg: AsyncIsrConfig):
    # LeaderHandleUpdate (:121-129), choice = version: adopt a newer update
    n = cfg.max_version + 1

    def kernel(s):
        v = choices(s, n)
        u = _at(s["upd_isr"], v)
        enabled = (u >= 0) & (v > col(s, "l_ver"))
        return _out(s, n, enabled, {
            "l_isr": u.clamp(min=0),
            "l_ver": v,
            "l_pend": torch.zeros_like(u),
            "l_pver": torch.full_like(u, NIL),
        })

    return Action("LeaderHandleUpdate", n, kernel,
                  writes=frozenset({"l_isr", "l_ver", "l_pend", "l_pver"}))


def follower_replicate(cfg: AsyncIsrConfig):
    # FollowerReplicate (:131-135), choice = replica
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        o_r = _at(s["offs"], r)
        enabled = (r != LEADER) & (o_r < s["offs"][:, LEADER : LEADER + 1])
        return _out(s, n, enabled, {
            "offs": _put(s["offs"], (o_r + 1).clamp(max=cfg.max_offset), r),
        })

    return Action("FollowerReplicate", n, kernel, writes=frozenset({"offs"}))


def valid_high_watermark(cfg: AsyncIsrConfig):
    # ValidHighWatermark (:161-162)
    def pred(s):
        hw = _hw(cfg, s).unsqueeze(-1)
        return torch.where(_members(cfg, s["c_isr"]), s["offs"] >= hw, True).all(dim=-1)

    return Invariant("ValidHighWatermark", pred)


def type_ok(cfg: AsyncIsrConfig):
    # TypeOk (:62-66) within the bounds
    V = cfg.max_version

    def pred(s):
        return (
            (s["c_ver"] >= 0) & (s["c_ver"] <= V)
            & (s["l_ver"] >= 0) & (s["l_ver"] <= V)
            & (s["l_pver"] >= NIL) & (s["l_pver"] <= V)
            & ((s["offs"] >= 0) & (s["offs"] <= cfg.max_offset)).all(dim=-1)
        )

    return Invariant("TypeOk", pred)


def make_decode(cfg: AsyncIsrConfig):
    """numpy fields of one state -> the JAX package's decoded form."""

    def iset(mask):
        return frozenset(r for r in range(cfg.n) if (int(mask) >> r) & 1)

    def decode(s):
        reqs = frozenset(
            (iset(subset), v)
            for v in range(cfg.max_version + 1)
            for subset in range(1 << cfg.n)
            if (int(s["req_bits"][v]) >> subset) & 1
        )
        upds = frozenset(
            (iset(s["upd_isr"][v]), v)
            for v in range(cfg.max_version + 1)
            if int(s["upd_isr"][v]) >= 0
        )
        return (
            (iset(s["c_isr"]), int(s["c_ver"])),
            (
                iset(s["l_isr"]),
                int(s["l_ver"]),
                iset(s["l_pend"]),
                int(s["l_pver"]),
                tuple(int(x) for x in s["offs"]),
            ),
            reqs,
            upds,
        )

    return decode


def make_model(cfg: AsyncIsrConfig, invariants=DEFAULT_INVARIANTS) -> Model:
    table = {"TypeOk": type_ok, "ValidHighWatermark": valid_high_watermark}
    return Model(
        name=f"AsyncIsr({cfg.n}r,M{cfg.max_offset},V{cfg.max_version})",
        spec=make_spec(cfg),
        init_states=lambda: [init_state(cfg)],
        actions=[
            controller_shrink_isr(cfg),
            controller_handle_request(cfg),
            leader_request_shrink_isr(cfg),
            leader_request_expand_isr(cfg),
            leader_write(cfg),
            leader_handle_update(cfg),
            follower_replicate(cfg),
        ],
        invariants=[table[n](cfg) for n in invariants],
        decode=make_decode(cfg),
        meta={"variant": "AsyncIsr", "cfg": cfg},
    )


# ==========================================================================
# oracle transcription
# ==========================================================================
# state = ((c_isr, c_ver), (l_isr, l_ver, pend, pver, offs), reqs, upds)
# with isr values as frozensets, reqs/upds as frozensets of (isr, version).


def o_init(cfg: AsyncIsrConfig):
    # Init (:137-150)
    full = frozenset(range(cfg.n))
    return (
        (full, 0),
        (full, 0, frozenset(), NIL, tuple([0] * cfg.n)),
        frozenset(),
        frozenset(),
    )


def _o_hw(s):
    # HighWatermark (:58-60)
    (_, _), (l_isr, _, pend, _, offs), _, _ = s
    return min(offs[r] for r in (l_isr | pend))


def make_oracle(cfg: AsyncIsrConfig, invariants=DEFAULT_INVARIANTS) -> OracleModel:
    # the oracle itself has no bitset (frozensets), but it exists to
    # cross-check the engine — accepting a config the engine cannot
    # encode would just diverge later, so the cliff check is shared
    check_encoding_bounds(cfg)
    V, M = cfg.max_version, cfg.max_offset

    def ctrl_shrink(s):
        # :72-79 (+ version constraint)
        (c_isr, c_ver), lstate, reqs, upds = s
        if c_ver >= V:
            return
        for r in range(cfg.n):
            if r != LEADER and r in c_isr:
                isr = c_isr - {r}
                yield ((isr, c_ver + 1), lstate, reqs, upds | {(isr, c_ver + 1)})

    def ctrl_handle(s):
        # :81-86 (+ version constraint)
        (c_isr, c_ver), lstate, reqs, upds = s
        if c_ver >= V:
            return
        for (isr, ver) in reqs:
            if ver == c_ver:
                yield ((isr, c_ver + 1), lstate, reqs, upds | {(isr, c_ver + 1)})

    def leader_req_shrink(s):
        # :88-100
        cstate, (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        for r in sorted(l_isr):
            if r == LEADER:
                continue
            isr = l_isr - {r}
            yield (
                cstate,
                (l_isr, l_ver, pend | isr, l_ver, offs),
                reqs | {(isr, l_ver)},
                upds,
            )

    def leader_req_expand(s):
        # :102-115
        cstate, (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        hw = _o_hw(s)
        for r in range(cfg.n):
            if r in l_isr or offs[r] < hw:
                continue
            isr = l_isr | {r}
            yield (
                cstate,
                (l_isr, l_ver, pend | isr, l_ver, offs),
                reqs | {(isr, l_ver)},
                upds,
            )

    def leader_write(s):
        # :117-119 (+ MaxOffset constraint)
        cstate, (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        if offs[LEADER] >= M:
            return
        offs2 = offs[:LEADER] + (offs[LEADER] + 1,) + offs[LEADER + 1 :]
        yield (cstate, (l_isr, l_ver, pend, pver, offs2), reqs, upds)

    def leader_handle_update(s):
        # :121-129
        cstate, (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        for (isr, ver) in upds:
            if ver > l_ver:
                yield (cstate, (isr, ver, frozenset(), NIL, offs), reqs, upds)

    def follower_replicate(s):
        # :131-135
        cstate, (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        for r in range(cfg.n):
            if r != LEADER and offs[r] < offs[LEADER]:
                offs2 = offs[:r] + (offs[r] + 1,) + offs[r + 1 :]
                yield (cstate, (l_isr, l_ver, pend, pver, offs2), reqs, upds)

    def valid_hw(s):
        # :161-162
        (c_isr, _), (_, _, _, _, offs), _, _ = s
        hw = _o_hw(s)
        return all(offs[r] >= hw for r in c_isr)

    def o_type_ok(s):
        (c_isr, c_ver), (l_isr, l_ver, pend, pver, offs), reqs, upds = s
        return (
            0 <= c_ver <= V
            and 0 <= l_ver <= V
            and NIL <= pver <= V
            and all(0 <= o <= M for o in offs)
        )

    table = {"TypeOk": o_type_ok, "ValidHighWatermark": valid_hw}
    return OracleModel(
        name="AsyncIsr-oracle",
        init_states=lambda: [o_init(cfg)],
        actions=[
            OracleAction("ControllerShrinkIsr", ctrl_shrink),
            OracleAction("ControllerHandleRequest", ctrl_handle),
            OracleAction("LeaderRequestShrinkIsr", leader_req_shrink),
            OracleAction("LeaderRequestExpandIsr", leader_req_expand),
            OracleAction("LeaderWrite", leader_write),
            OracleAction("LeaderHandleUpdate", leader_handle_update),
            OracleAction("FollowerReplicate", follower_replicate),
        ],
        invariants=[(n, table[n]) for n in invariants],
        meta={"variant": "AsyncIsr", "cfg": cfg},
    )
