"""KafkaReplication: the shared protocol core, as batched PyTorch kernels.

Counterpart of ``kafka_specification_tpu/models/kafka_replication.py``.
Same constants, the same encoding of the six state variables, the same
actions, truncation offsets, invariants and decoder, so both packages
reach the same states in the same order; and below the kernels, the same
set-semantics oracle transcription (``o_*``), whose states are the
decoder's canonical values, so engine and oracle levels compare as sets.

Value conventions: replicas are 0..N-1, `None` and `Nil` are -1, an epoch
slot with no LeaderAndIsr request is -2, ISRs are bitmasks.

Batching: an action kernel takes states as a dict of int64[B, *shape] and
works on every (state, choice) cell at once.  In the helpers below an index
or value of one cell is an int64[B, n] tensor (or [1, n] when it depends on
the choice only); ``_at`` reads a field element per cell, ``_put`` returns a
field of shape [B, n, *shape] with one element per cell replaced, where the
JAX kernel does ``x.at[i].set(v)`` on one state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.packing import Field, StateSpec
from ..oracle.interp import OracleAction
from .base import Action, Invariant

NONE = -1  # KafkaReplication.tla:38
NIL = -1  # KafkaReplication.tla:39
ABSENT = -2  # epoch slot with no LeaderAndIsr request yet

# each action's write set (``Action.writes``), the JAX package's
_CTRL_WRITES = frozenset({"nep", "qep", "qldr", "qisr", "req_ldr", "req_isr"})
_QUORUM_WRITES = frozenset({"qisr", "isr"})
_BECOME_FOLLOWER_WRITES = frozenset({"rid", "repoch", "end", "ep", "ldr", "isr", "hw"})
_REPLICATE_WRITES = frozenset({"rid", "repoch", "end", "hw"})


@dataclass(frozen=True)
class Config:
    """Constant valuation: Replicas/LogSize/MaxRecords/MaxLeaderEpoch
    (KafkaReplication.tla:32-36)."""

    n_replicas: int
    log_size: int
    max_records: int
    max_leader_epoch: int

    @property
    def n(self):
        return self.n_replicas

    @property
    def l(self):
        return self.log_size

    @property
    def r(self):
        return self.max_records

    @property
    def e(self):
        return self.max_leader_epoch

    @property
    def full_isr(self):
        return (1 << self.n_replicas) - 1


def make_spec(cfg: Config) -> StateSpec:
    """Lane encoding of the 6 state variables (same fields, same order)."""
    N, L, R, E = cfg.n, cfg.l, cfg.r, cfg.e
    return StateSpec(
        [
            Field("end", (N,), 0, L),
            Field("rid", (N, L), NIL, R - 1),
            Field("repoch", (N, L), NIL, E),
            Field("hw", (N,), 0, L),
            Field("ep", (N,), NIL, E),
            Field("ldr", (N,), NONE, N - 1),
            Field("isr", (N,), 0, cfg.full_isr),
            Field("nrid", (), 0, R),
            Field("nep", (), 0, E + 1),
            Field("qep", (), NIL, E),
            Field("qldr", (), NONE, N - 1),
            Field("qisr", (), 0, cfg.full_isr),
            Field("req_ldr", (E + 1,), ABSENT, N - 1),
            Field("req_isr", (E + 1,), 0, cfg.full_isr),
        ]
    )


def init_state(cfg: Config) -> dict:
    """Init (KafkaReplication.tla:109-120)."""
    N, L, E = cfg.n, cfg.l, cfg.e
    return {
        "end": [0] * N,
        "rid": [[NIL] * L for _ in range(N)],
        "repoch": [[NIL] * L for _ in range(N)],
        "hw": [0] * N,
        "ep": [NIL] * N,
        "ldr": [NONE] * N,
        "isr": [0] * N,
        "nrid": 0,
        "nep": 0,
        "qep": NIL,
        "qldr": NONE,
        "qisr": cfg.full_isr,
        "req_ldr": [ABSENT] * (E + 1),
        "req_isr": [0] * (E + 1),
    }


# --------------------------------------------------------------------------
# batched kernel helpers
# --------------------------------------------------------------------------


def _first(s: dict) -> torch.Tensor:
    """Any field of the batch: its device and batch size are the batch's."""
    return next(iter(s.values()))


def choices(s: dict, n: int) -> torch.Tensor:
    """The choice index of each cell: int64[1, n]."""
    return torch.arange(n, device=_first(s).device).unsqueeze(0)


def col(s: dict, name: str) -> torch.Tensor:
    """A scalar field as a [B, 1] column, to broadcast against cells."""
    return s[name].unsqueeze(1)


def _at(x: torch.Tensor, *idx) -> torch.Tensor:
    """Per-cell element read: x[b, i0[b, c], i1[b, c], ...] -> [B, n]."""
    b = x.shape[0]
    flat = idx[0]
    for size, i in zip(x.shape[2:], idx[1:]):
        flat = flat * size + i
    return x.reshape(b, -1).gather(1, flat.expand(b, flat.shape[1]))


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-cell row read of a [B, N, L] field: x[b, i[b, c], :] -> [B, n, L]."""
    b, _, length = x.shape
    i = i.expand(b, i.shape[1])
    return x.gather(1, i.unsqueeze(-1).expand(b, i.shape[1], length))


def _put(x: torch.Tensor, val, *idx) -> torch.Tensor:
    """Per-cell functional write: a [B, n, *shape] field equal to x
    everywhere except element idx of each cell, which holds val."""
    shape = x.shape[1:]
    nd = len(shape)
    hit = None
    for d, (size, i) in enumerate(zip(shape, idx)):
        ar = torch.arange(size, device=x.device).view(
            [size if j == d else 1 for j in range(nd)]
        )
        h = ar == i.reshape(*i.shape, *([1] * nd))
        hit = h if hit is None else hit & h
    if not isinstance(val, int):  # a tensor (or the analysis's IVal)
        val = val.reshape(*val.shape, *([1] * nd))
    return torch.where(hit, val, x.unsqueeze(1))


def _vec(x: torch.Tensor) -> torch.Tensor:
    """A [B, N] field seen from every cell: [B, 1, N]."""
    return x.unsqueeze(1)


def _bit(r):
    return torch.ones_like(r) << r


def _member(mask, r):
    return ((mask >> r) & 1) == 1


def _out(s: dict, n: int, enabled, upd: dict):
    """(enabled[B, n], next state[B, n, ...]) with untouched fields shared."""
    b = _first(s).shape[0]
    nxt = {}
    for k, v in s.items():
        shape = (b, n, *v.shape[1:])
        nxt[k] = torch.broadcast_to(upd[k], shape) if k in upd else (
            v.unsqueeze(1).expand(shape)
        )
    return torch.broadcast_to(enabled, (b, n)), nxt


def _is_true_leader(s, l):
    # IsTrueLeader (:128-131)
    return (
        (col(s, "qldr") == l)
        & (_at(s["ldr"], l) == l)
        & (_at(s["ep"], l) == col(s, "qep"))
    )


def _caught_up(s, l, f, end_offset):
    # IsFollowerCaughtUp(leader, follower, endOffset) (:219-225)
    following = _at(s["ldr"], f) == l
    nonzero = (
        (end_offset > 0)
        & (end_offset <= _at(s["end"], l))
        & (_at(s["end"], f) >= end_offset)
    )
    return following & ((end_offset == 0) | nonzero)


def _forall_isr(cfg, isr_mask, cond_vec):
    """\\A follower \\in isr : cond[follower]; isr_mask [B, n], cond [B, n, N]."""
    ar = torch.arange(cfg.n, device=isr_mask.device)
    members = ((isr_mask.unsqueeze(-1) >> ar) & 1) == 1
    return torch.where(members, cond_vec, True).all(dim=-1)


def _truncate_log(cfg, s, r, new_end):
    """ReplicaLog!TruncateTo Nil-fill (FiniteReplicatedLog.tla:105-109) of
    replica r's log to new_end; caller guards new_end <= end[r]."""
    dev = new_end.device
    rows = torch.arange(cfg.n, device=dev).view(cfg.n, 1)
    offs = torch.arange(cfg.l, device=dev)
    drop = (rows == r.unsqueeze(-1).unsqueeze(-1)) & (
        offs >= new_end.unsqueeze(-1).unsqueeze(-1)
    )
    rid = torch.where(drop, NIL, s["rid"].unsqueeze(1))
    repoch = torch.where(drop, NIL, s["repoch"].unsqueeze(1))
    return rid, repoch, _put(s["end"], new_end, r)


def _ctrl_update_isr(cfg, s, new_leader, new_isr):
    """ControllerUpdateIsr(newLeader, newIsr) (:138-145): consume a fresh
    epoch, write quorumState, append the LeaderAndIsr request.
    Returns (enabled, updates)."""
    e = col(s, "nep")
    ok = e <= cfg.e  # IdSequence.tla:31
    ec = e.clamp(max=cfg.e)
    return ok, {
        "nep": (e + 1).clamp(max=cfg.e + 1),
        "qep": ec,
        "qldr": new_leader,
        "qisr": new_isr,
        "req_ldr": _put(s["req_ldr"], new_leader, ec),
        "req_isr": _put(s["req_isr"], new_isr, ec),
    }


def _quorum_update(s, l, new_isr):
    """QuorumUpdateLeaderAndIsr (:213-217). Returns (enabled, updates)."""
    return _is_true_leader(s, l), {
        "qisr": new_isr,
        "isr": _put(s["isr"], new_isr, l),
    }


# --------------------------------------------------------------------------
# shared action kernels (KafkaReplication.tla:138-310)
# --------------------------------------------------------------------------


def controller_shrink_isr(cfg: Config):
    # ControllerShrinkIsr (:158-168), choice = replica
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        qldr, qisr = col(s, "qldr"), col(s, "qisr")
        is_ldr = qldr == r
        sole = qisr == _bit(r)
        case1 = is_ldr & sole
        case2 = is_ldr & ~sole
        case3 = ~is_ldr & _member(qisr, r)
        enabled = case1 | case2 | case3
        new_leader = torch.where(case3, qldr, NONE)
        new_isr = torch.where(case1, qisr, qisr & ~_bit(r))
        ok, upd = _ctrl_update_isr(cfg, s, new_leader, new_isr)
        return _out(s, n, enabled & ok, upd)

    return Action("ControllerShrinkIsr", n, kernel, writes=_CTRL_WRITES)


def controller_elect_leader(cfg: Config):
    # ControllerElectLeader (:176-179), choice = newLeader in quorum ISR
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        qisr = col(s, "qisr")
        enabled = _member(qisr, r) & (col(s, "qldr") != r)
        ok, upd = _ctrl_update_isr(cfg, s, r, qisr)
        return _out(s, n, enabled & ok, upd)

    return Action("ControllerElectLeader", n, kernel, writes=_CTRL_WRITES)


def become_leader(cfg: Config):
    # BecomeLeader (:186-195), choice = request (keyed by its unique epoch)
    n = cfg.e + 1

    def kernel(s):
        e = choices(s, n)
        l = _at(s["req_ldr"], e)
        lc = l.clamp(0, cfg.n - 1)
        enabled = (l >= 0) & (e > _at(s["ep"], lc))
        return _out(s, n, enabled, {
            "ep": _put(s["ep"], e, lc),
            "ldr": _put(s["ldr"], lc, lc),
            "isr": _put(s["isr"], _at(s["req_isr"], e), lc),
        })

    return Action("BecomeLeader", n, kernel, writes=frozenset({"ep", "ldr", "isr"}))


def leader_write(cfg: Config):
    # LeaderWrite (:202-207), choice = replica; id/offset are forced
    n = cfg.n

    def kernel(s):
        r = choices(s, n)
        end = _at(s["end"], r)
        nrid = col(s, "nrid")
        enabled = (_at(s["ldr"], r) == r) & (nrid < cfg.r) & (end < cfg.l)
        off = end.clamp(max=cfg.l - 1)
        return _out(s, n, enabled, {
            "rid": _put(
                s["rid"], torch.where(enabled, nrid, _at(s["rid"], r, off)), r, off
            ),
            "repoch": _put(
                s["repoch"],
                torch.where(enabled, _at(s["ep"], r), _at(s["repoch"], r, off)),
                r,
                off,
            ),
            "end": _put(s["end"], torch.where(enabled, end + 1, end), r),
            "nrid": (nrid + 1).clamp(max=cfg.r),
        })

    return Action("LeaderWrite", n, kernel, writes=frozenset({"rid", "repoch", "end", "nrid"}))


def leader_shrink_isr(cfg: Config):
    # LeaderShrinkIsr (:233-239), choice = (leader, replica in isr \ {leader})
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        in_isr = (f != l) & _member(isr_l, f)
        lagging = ~_caught_up(s, l, f, _at(s["end"], l))
        ok, upd = _quorum_update(s, l, isr_l & ~_bit(f))
        return _out(s, n, in_isr & lagging & ok, upd)

    return Action("LeaderShrinkIsr", n, kernel, writes=_QUORUM_WRITES)


def leader_expand_isr(cfg: Config):
    # LeaderExpandIsr (:248-254), choice = (leader, replica not in isr)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        outside = ~_member(isr_l, f)
        caught = _caught_up(s, l, f, _at(s["hw"], l))
        ok, upd = _quorum_update(s, l, isr_l | _bit(f))
        return _out(s, n, outside & caught & ok, upd)

    return Action("LeaderExpandIsr", n, kernel, writes=_QUORUM_WRITES)


def leader_inc_high_watermark(cfg: Config):
    # LeaderIncHighWatermark (:264-271), choice = leader; offset forced = hw.
    # No epoch verification: the pre-KIP-320 hole (:256-263).
    n = cfg.n

    def kernel(s):
        l = choices(s, n)
        hw = _at(s["hw"], l)
        presumes = _at(s["ldr"], l) == l
        in_offsets = hw < cfg.l
        follows = (_vec(s["ldr"]) == l.unsqueeze(-1)) & (
            _vec(s["end"]) > hw.unsqueeze(-1)
        )
        all_isr = _forall_isr(cfg, _at(s["isr"], l), follows)
        return _out(s, n, presumes & in_offsets & all_isr, {
            "hw": _put(s["hw"], (hw + 1).clamp(max=cfg.l), l),
        })

    return Action("LeaderIncHighWatermark", n, kernel, writes=frozenset({"hw"}))


def become_follower_and_truncate_to(cfg: Config, name: str, trunc_offset_fn):
    """BecomeFollowerAndTruncateTo(leader, replica, truncationOffset)
    (:281-294), choice = (replica, request-epoch); leader = request.leader.
    trunc_offset_fn(s, l, r) -> truncation offset on the old state."""
    n = cfg.n * (cfg.e + 1)

    def kernel(s):
        c = choices(s, n)
        r, e = c // (cfg.e + 1), c % (cfg.e + 1)
        l = _at(s["req_ldr"], e)
        lc = l.clamp(0, cfg.n - 1)
        enabled = (l >= 0) & (lc != r) & (e > _at(s["ep"], r))
        toff = trunc_offset_fn(s, lc, r)
        enabled = enabled & (toff <= _at(s["end"], r))  # TruncateTo guard
        toff = toff.clamp(0, cfg.l)
        rid, repoch, end = _truncate_log(cfg, s, r, toff)
        return _out(s, n, enabled, {
            "rid": rid,
            "repoch": repoch,
            "end": end,
            "ep": _put(s["ep"], e, r),
            "ldr": _put(s["ldr"], lc, r),
            "isr": _put(s["isr"], _at(s["req_isr"], e), r),
            "hw": _put(s["hw"], torch.minimum(toff, _at(s["hw"], r)), r),
        })

    return Action(name, n, kernel, writes=_BECOME_FOLLOWER_WRITES)


def follower_replicate(cfg: Config):
    # FollowerReplicate (:302-310), choice = (follower, leader); unfenced
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        f, l = c // cfg.n, c % cfg.n
        off = _at(s["end"], f)
        enabled = (
            (_at(s["ldr"], l) == l)
            & (_at(s["ldr"], f) == l)
            & (off < cfg.l)
            & (off < _at(s["end"], l))
        )
        return _out(s, n, enabled, _replicate(cfg, s, f, l, off, enabled))

    return Action("FollowerReplicate", n, kernel, writes=_REPLICATE_WRITES)


def _replicate(cfg, s, f, l, off, enabled):
    """The updates of a follower fetch: copy the leader's record at `off`
    into the follower's log, bump its end and take min(leader hw, off+1)."""
    offc = off.clamp(max=cfg.l - 1)
    new_hw = torch.minimum(_at(s["hw"], l), off + 1)
    return {
        "rid": _put(
            s["rid"],
            torch.where(enabled, _at(s["rid"], l, offc), _at(s["rid"], f, offc)),
            f,
            offc,
        ),
        "repoch": _put(
            s["repoch"],
            torch.where(
                enabled, _at(s["repoch"], l, offc), _at(s["repoch"], f, offc)
            ),
            f,
            offc,
        ),
        "end": _put(s["end"], torch.where(enabled, off + 1, off), f),
        "hw": _put(s["hw"], torch.where(enabled, new_hw, _at(s["hw"], f)), f),
    }


# --------------------------------------------------------------------------
# variant truncation offsets (Kip101.tla / Kip279.tla)
# --------------------------------------------------------------------------


def truncate_to_hw_offset(cfg: Config):
    # truncate to own HW (KafkaTruncateToHighWatermark.tla:29-31)
    def fn(s, l, r):
        return _at(s["hw"], r)

    return fn


def kip101_offset(cfg: Config):
    """LookupOffsetForEpoch (Kip101.tla:31-39) per
    BecomeFollowerTruncateKip101 (Kip101.tla:41-47)."""

    def fn(s, l, r):
        offs = torch.arange(cfg.l, device=l.device)
        r_end = _at(s["end"], r)
        epoch = _at(s["repoch"], r, (r_end - 1).clamp(0, cfg.l - 1))
        l_end = _at(s["end"], l)
        hw_r = _at(s["hw"], r)
        larger = (offs < l_end.unsqueeze(-1)) & (
            _row(s["repoch"], l) > epoch.unsqueeze(-1)
        )
        any_larger = larger.any(dim=-1)
        min_larger = torch.where(larger, offs, cfg.l).min(dim=-1).values
        latest_match = (
            _at(s["repoch"], l, (l_end - 1).clamp(0, cfg.l - 1)) == epoch
        )
        lookup = torch.where(
            l_end == 0,
            hw_r,
            torch.where(
                latest_match, l_end, torch.where(any_larger, min_larger, hw_r)
            ),
        )
        return torch.where(r_end == 0, 0, lookup)

    return fn


def kip279_offset(cfg: Config):
    """FirstNonMatchingOffsetFromTail (Kip279.tla:39-45): the last offset
    whose (id, epoch) entry matches in both logs, plus one, else 0."""

    def fn(s, l, r):
        offs = torch.arange(cfg.l, device=l.device)
        l_end = _at(s["end"], l)
        match = (
            (offs < _at(s["end"], r).unsqueeze(-1))
            & (offs < l_end.unsqueeze(-1))
            & (_row(s["rid"], r) == _row(s["rid"], l))
            & (_row(s["repoch"], r) == _row(s["repoch"], l))
        )
        any_match = match.any(dim=-1)
        max_match = torch.where(match, offs, -1).max(dim=-1).values
        return torch.where((l_end == 0) | ~any_match, 0, max_match + 1)

    return fn


# --------------------------------------------------------------------------
# invariants (KafkaReplication.tla:101-107, 320-345), batched over [B]
# --------------------------------------------------------------------------


def _isr_property(cfg: Config, s, isr_of_r1):
    """WeakIsr/StrongIsr core (:320-340): for every presumed leader r1, every
    member r2 of isr_of_r1[:, r1] has an identical log below r1's hw."""
    dev = s["end"].device
    offs = torch.arange(cfg.l, device=dev)
    ar = torch.arange(cfg.n, device=dev)
    end = s["end"]
    has1 = offs < end[:, :, None, None]  # [B, r1, 1, L]
    has2 = offs < end[:, None, :, None]  # [B, 1, r2, L]
    same = (s["rid"][:, :, None, :] == s["rid"][:, None, :, :]) & (
        s["repoch"][:, :, None, :] == s["repoch"][:, None, :, :]
    )
    pair_ok = has1 & has2 & same
    below_hw = offs < s["hw"][:, :, None, None]
    r2_in = ((isr_of_r1[:, :, None] >> ar) & 1) == 1  # [B, r1, r2]
    relevant = below_hw & r2_in[..., None]
    ok_r1 = torch.where(relevant, pair_ok, True).flatten(2).all(dim=-1)
    presumes = s["ldr"] == ar
    return torch.where(presumes, ok_r1, True).all(dim=-1)


def weak_isr(cfg: Config):
    # WeakIsr (:320-326): r2 ranges over the presumed leader's local ISR
    def pred(s):
        return _isr_property(cfg, s, s["isr"])

    return Invariant("WeakIsr", pred)


def strong_isr(cfg: Config):
    # StrongIsr (:334-340): r2 ranges over the quorum ISR
    def pred(s):
        return _isr_property(cfg, s, col(s, "qisr").expand(-1, cfg.n))

    return Invariant("StrongIsr", pred)


def leader_in_isr_literal(cfg: Config):
    # LeaderInIsr (:345) taken literally: False whenever leader = None
    def pred(s):
        lc = s["qldr"].clamp(0, cfg.n - 1)
        return (s["qldr"] >= 0) & _member(s["qisr"], lc)

    return Invariant("LeaderInIsrLiteral", pred)


def leader_in_isr(cfg: Config):
    # evident intent of (:345): a real leader is always in the quorum ISR
    def pred(s):
        lc = s["qldr"].clamp(0, cfg.n - 1)
        return (s["qldr"] < 0) | _member(s["qisr"], lc)

    return Invariant("LeaderInIsr", pred)


def type_ok(cfg: Config):
    """TypeOk (:101-107): sequence bounds, record well-formedness, canonical
    Nil padding, state ranges."""

    def pred(s):
        offs = torch.arange(cfg.l, device=s["end"].device)
        written = offs < s["end"].unsqueeze(-1)
        rid, repoch = s["rid"], s["repoch"]
        recs_ok = torch.where(
            written,
            (rid >= 0) & (rid < cfg.r) & (repoch >= 0) & (repoch <= cfg.e),
            (rid == NIL) & (repoch == NIL),
        ).flatten(1).all(dim=-1)
        seq_ok = (
            (s["nrid"] >= 0) & (s["nrid"] <= cfg.r)
            & (s["nep"] >= 0) & (s["nep"] <= cfg.e + 1)
        )
        rs_ok = (
            ((s["hw"] >= 0) & (s["hw"] <= cfg.l)).all(dim=-1)
            & ((s["ep"] >= NIL) & (s["ep"] <= cfg.e)).all(dim=-1)
            & ((s["ldr"] >= NONE) & (s["ldr"] < cfg.n)).all(dim=-1)
            & ((s["isr"] >= 0) & (s["isr"] <= cfg.full_isr)).all(dim=-1)
        )
        q_ok = (
            (s["qep"] >= NIL) & (s["qep"] <= cfg.e)
            & (s["qldr"] >= NONE) & (s["qldr"] < cfg.n)
            & (s["qisr"] >= 0) & (s["qisr"] <= cfg.full_isr)
        )
        return recs_ok & seq_ok & rs_ok & q_ok

    return Invariant("TypeOk", pred)


# --------------------------------------------------------------------------
# decode: one unpacked state (numpy fields) -> canonical Python state
# --------------------------------------------------------------------------


def make_decode(cfg: Config):
    """Canonical Python state, equal to the JAX package's decoded form:
    (logs, rstates, nrid, nep, reqs, quorum) with
      logs    = tuple_N of tuple of (id, epoch)
      rstates = tuple_N of (hw, epoch, leader, isr_frozenset)
      reqs    = frozenset of (epoch, leader, isr_frozenset)
      quorum  = (epoch, leader, isr_frozenset)
    """

    # every ISR bitmask's frozenset, built once: decoding a whole level
    # (engine vs oracle, level for level) calls this a dozen times a state
    isets = [frozenset(r for r in range(cfg.n) if (mask >> r) & 1)
             for mask in range(1 << cfg.n)]

    def iset(mask):
        return isets[int(mask)]

    def decode(s):
        logs = tuple(
            tuple(
                (int(s["rid"][r][o]), int(s["repoch"][r][o]))
                for o in range(int(s["end"][r]))
            )
            for r in range(cfg.n)
        )
        rstates = tuple(
            (int(s["hw"][r]), int(s["ep"][r]), int(s["ldr"][r]), iset(s["isr"][r]))
            for r in range(cfg.n)
        )
        reqs = frozenset(
            (e, int(s["req_ldr"][e]), iset(s["req_isr"][e]))
            for e in range(cfg.e + 1)
            if int(s["req_ldr"][e]) != ABSENT
        )
        quorum = (int(s["qep"]), int(s["qldr"]), iset(s["qisr"]))
        return (logs, rstates, int(s["nrid"]), int(s["nep"]), reqs, quorum)

    return decode


# ==========================================================================
# oracle transcription (independent set semantics; the golden source)
# ==========================================================================
#
# Oracle state mirrors make_decode's canonical form exactly.  Indices below
# cite the corpus's KafkaReplication.tla.


def o_init(cfg: Config):
    # Init (:109-120)
    logs = tuple(() for _ in range(cfg.n))
    rstates = tuple((0, NIL, NONE, frozenset()) for _ in range(cfg.n))
    quorum = (NIL, NONE, frozenset(range(cfg.n)))
    return (logs, rstates, 0, 0, frozenset(), quorum)


def _o_ctrl_update(cfg, s, new_leader, new_isr):
    # ControllerUpdateIsr (:138-145); None if epochs exhausted
    logs, rstates, nrid, nep, reqs, quorum = s
    if nep > cfg.e:
        return None
    req = (nep, new_leader, frozenset(new_isr))
    return (logs, rstates, nrid, nep + 1, reqs | {req}, req)


def o_controller_shrink_isr(cfg: Config):
    # ControllerShrinkIsr (:158-168)
    def successors(s):
        _, _, _, _, _, (qep, qldr, qisr) = s
        for r in range(cfg.n):
            if qldr == r and qisr == {r}:
                t = _o_ctrl_update(cfg, s, NONE, qisr)
            elif qldr == r and qisr != {r}:
                t = _o_ctrl_update(cfg, s, NONE, qisr - {r})
            elif qldr != r and r in qisr:
                t = _o_ctrl_update(cfg, s, qldr, qisr - {r})
            else:
                continue
            if t is not None:
                yield t

    return OracleAction("ControllerShrinkIsr", successors)


def o_controller_elect_leader(cfg: Config):
    # ControllerElectLeader (:176-179)
    def successors(s):
        _, _, _, _, _, (qep, qldr, qisr) = s
        for n in sorted(qisr):
            if qldr != n:
                t = _o_ctrl_update(cfg, s, n, qisr)
                if t is not None:
                    yield t

    return OracleAction("ControllerElectLeader", successors)


def o_become_leader(cfg: Config):
    # BecomeLeader (:186-195)
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for (e, l, risr) in reqs:
            if l != NONE and e > rstates[l][1]:
                hw = rstates[l][0]
                new_rs = rstates[:l] + ((hw, e, l, risr),) + rstates[l + 1 :]
                yield (logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("BecomeLeader", successors)


def o_leader_write(cfg: Config):
    # LeaderWrite (:202-207): presumed leader appends [id |-> nextRecordId,
    # epoch |-> own epoch]; RecordSeq!NextId bumps the counter.
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        if nrid >= cfg.r:
            return
        for r in range(cfg.n):
            if rstates[r][2] == r and len(logs[r]) < cfg.l:
                rec = (nrid, rstates[r][1])
                new_logs = logs[:r] + (logs[r] + (rec,),) + logs[r + 1 :]
                yield (new_logs, rstates, nrid + 1, nep, reqs, quorum)

    return OracleAction("LeaderWrite", successors)


def _o_is_true_leader(s, l):
    # IsTrueLeader (:128-131)
    _, rstates, _, _, _, (qep, qldr, _) = s
    return qldr == l and rstates[l][2] == l and rstates[l][1] == qep


def _o_quorum_update(s, l, new_isr):
    # QuorumUpdateLeaderAndIsr (:213-217)
    if not _o_is_true_leader(s, l):
        return None
    logs, rstates, nrid, nep, reqs, (qep, qldr, qisr) = s
    fs = frozenset(new_isr)
    hw, ep, ldr, _ = rstates[l]
    new_rs = rstates[:l] + ((hw, ep, ldr, fs),) + rstates[l + 1 :]
    return (logs, new_rs, nrid, nep, reqs, (qep, qldr, fs))


def _o_caught_up(s, l, f, end_offset):
    # IsFollowerCaughtUp (:219-225)
    logs, rstates, _, _, _, _ = s
    if rstates[f][2] != l:
        return False
    if end_offset == 0:
        return True
    return end_offset <= len(logs[l]) and len(logs[f]) >= end_offset


def o_leader_shrink_isr(cfg: Config):
    # LeaderShrinkIsr (:233-239)
    def successors(s):
        _, rstates, _, _, _, _ = s
        logs = s[0]
        for l in range(cfg.n):
            isr = rstates[l][3]
            for f in sorted(isr - {l}):
                if not _o_caught_up(s, l, f, len(logs[l])):
                    t = _o_quorum_update(s, l, isr - {f})
                    if t is not None:
                        yield t

    return OracleAction("LeaderShrinkIsr", successors)


def o_leader_expand_isr(cfg: Config):
    # LeaderExpandIsr (:248-254)
    def successors(s):
        _, rstates, _, _, _, _ = s
        for l in range(cfg.n):
            isr = rstates[l][3]
            hw = rstates[l][0]
            for f in range(cfg.n):
                if f not in isr and _o_caught_up(s, l, f, hw):
                    t = _o_quorum_update(s, l, isr | {f})
                    if t is not None:
                        yield t

    return OracleAction("LeaderExpandIsr", successors)


def o_leader_inc_high_watermark(cfg: Config):
    # LeaderIncHighWatermark (:264-271)
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for l in range(cfg.n):
            hw, ep, ldr, isr = rstates[l]
            if ldr != l or hw >= cfg.l:
                continue
            if all(rstates[f][2] == l and len(logs[f]) > hw for f in isr):
                new_rs = rstates[:l] + ((hw + 1, ep, ldr, isr),) + rstates[l + 1 :]
                yield (logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("LeaderIncHighWatermark", successors)


def o_become_follower_and_truncate_to(cfg: Config, name: str, trunc_offset_fn):
    # BecomeFollowerAndTruncateTo (:281-294) composed per-variant; leader
    # ranges over Replicas in every variant, so the None branch is dead.
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for (e, l, risr) in reqs:
            if l == NONE:
                continue
            for r in range(cfg.n):
                if r == l or e <= rstates[r][1]:
                    continue
                toff = trunc_offset_fn(cfg, s, l, r)
                if toff > len(logs[r]):  # TruncateTo guard (FRL:106)
                    continue
                new_logs = logs[:r] + (logs[r][:toff],) + logs[r + 1 :]
                new_hw = min(toff, rstates[r][0])
                new_rs = rstates[:r] + ((new_hw, e, l, risr),) + rstates[r + 1 :]
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction(name, successors)


def o_follower_replicate(cfg: Config):
    # FollowerReplicate (:302-310)
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for f in range(cfg.n):
            for l in range(cfg.n):
                if rstates[l][2] != l or rstates[f][2] != l:
                    continue
                off = len(logs[f])
                if off >= cfg.l or off >= len(logs[l]):
                    continue
                new_logs = logs[:f] + (logs[f] + (logs[l][off],),) + logs[f + 1 :]
                new_hw = min(rstates[l][0], off + 1)
                hwf, epf, ldrf, isrf = rstates[f]
                new_rs = rstates[:f] + ((new_hw, epf, ldrf, isrf),) + rstates[f + 1 :]
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FollowerReplicate", successors)


# variant truncation offsets, oracle side ---------------------------------


def o_truncate_to_hw_offset(cfg, s, l, r):
    # KafkaTruncateToHighWatermark.tla:29-31
    return s[1][r][0]


def o_kip101_offset(cfg, s, l, r):
    # Kip101.tla:27-47
    logs, rstates, *_ = s
    if len(logs[r]) == 0:
        return 0
    epoch = logs[r][-1][1]
    if len(logs[l]) == 0:
        return rstates[r][0]
    if logs[l][-1][1] == epoch:
        return len(logs[l])
    larger = [o for o, (_, ep) in enumerate(logs[l]) if ep > epoch]
    return min(larger) if larger else rstates[r][0]


def o_kip279_offset(cfg, s, l, r):
    # Kip279.tla:27-45
    logs = s[0]
    if len(logs[l]) == 0:
        return 0
    matching = [
        o
        for o, rec in enumerate(logs[r])
        if o < len(logs[l]) and logs[l][o] == rec
    ]
    return (max(matching) + 1) if matching else 0


# oracle invariants --------------------------------------------------------


def o_weak_isr(cfg: Config):
    # WeakIsr (:320-326)
    def pred(s):
        logs, rstates, *_ = s
        for r1 in range(cfg.n):
            hw, _, ldr, isr = rstates[r1]
            if ldr != r1:
                continue
            for r2 in isr:
                for off in range(hw):
                    if off >= len(logs[r1]) or off >= len(logs[r2]):
                        return False
                    if logs[r1][off] != logs[r2][off]:
                        return False
        return True

    return ("WeakIsr", pred)


def o_strong_isr(cfg: Config):
    # StrongIsr (:334-340)
    def pred(s):
        logs, rstates, _, _, _, (_, _, qisr) = s
        for r1 in range(cfg.n):
            hw, _, ldr, _ = rstates[r1]
            if ldr != r1:
                continue
            for r2 in qisr:
                for off in range(hw):
                    if off >= len(logs[r1]) or off >= len(logs[r2]):
                        return False
                    if logs[r1][off] != logs[r2][off]:
                        return False
        return True

    return ("StrongIsr", pred)


def o_leader_in_isr_literal(cfg: Config):
    # LeaderInIsr (:345), literal
    def pred(s):
        _, _, _, _, _, (_, qldr, qisr) = s
        return qldr in qisr

    return ("LeaderInIsrLiteral", pred)


def o_leader_in_isr(cfg: Config):
    def pred(s):
        _, _, _, _, _, (_, qldr, qisr) = s
        return qldr == NONE or qldr in qisr

    return ("LeaderInIsr", pred)


def o_type_ok(cfg: Config):
    # TypeOk (:101-107) on the canonical representation
    def pred(s):
        logs, rstates, nrid, nep, reqs, (qep, qldr, qisr) = s
        if not (0 <= nrid <= cfg.r and 0 <= nep <= cfg.e + 1):
            return False
        for log in logs:
            if len(log) > cfg.l:
                return False
            if any(not (0 <= i < cfg.r and 0 <= e <= cfg.e) for i, e in log):
                return False
        for hw, ep, ldr, isr in rstates:
            if not (0 <= hw <= cfg.l and NIL <= ep <= cfg.e and NONE <= ldr < cfg.n):
                return False
            if not isr <= set(range(cfg.n)):
                return False
        return NIL <= qep <= cfg.e and NONE <= qldr < cfg.n

    return ("TypeOk", pred)
