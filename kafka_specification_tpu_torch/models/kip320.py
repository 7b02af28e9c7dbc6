"""Kip320, the fenced replication protocol (the flagship model), and
Kip320FirstTry, the rejected truncate-on-fetch-error design (PyTorch).

Counterpart of ``kafka_specification_tpu/models/kip320.py``.  Kip320's Next
(Kip320.tla:150-159) keeps the controller actions, BecomeLeader and
LeaderWrite from the core and replaces the five replica-side actions with
fenced versions (:49-148); its THEOREMs (:168-171) say TypeOk, LeaderInIsr,
WeakIsr and StrongIsr all hold.  Kip320FirstTry (Kip320FirstTry.tla:159-169)
lets followers fetch at once and truncate on an epoch mismatch; it fails
StrongIsr.  The set-semantics oracles of both (``make_oracle``,
``make_first_try_oracle``) are at the end.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..oracle.interp import OracleAction, OracleModel
from . import kafka_replication as kr
from .base import Action, Model
from .kafka_replication import NONE, Config, _at, _bit, _member, _out, _put, _row, _vec, choices
from .variants import DEFAULT_INVARIANTS, _invariant_oracles, invariant_kernels


# --------------------------------------------------------------------------
# Kip320 kernels (Kip320.tla:39-148)
# --------------------------------------------------------------------------


def _following_epoch(s, l, f):
    # IsFollowingLeaderEpoch (Kip320.tla:39-42)
    return (
        (_at(s["ldr"], l) == l)
        & (_at(s["ldr"], f) == l)
        & (_at(s["ep"], f) == _at(s["ep"], l))
    )


def _following_epoch_vec(s, l):
    """IsFollowingLeaderEpoch(l, f) for every follower f: [B, n, N]."""
    return (
        (_at(s["ldr"], l) == l).unsqueeze(-1)
        & (_vec(s["ldr"]) == l.unsqueeze(-1))
        & (_vec(s["ep"]) == _at(s["ep"], l).unsqueeze(-1))
    )


def _hw_at_epoch(cfg, s, l, hw):
    # HasHighWatermarkReachedCurrentEpoch (Kip320.tla:87-92)
    end_l = _at(s["end"], l)
    return (hw == end_l) | (
        (hw < end_l)
        & (_at(s["repoch"], l, hw.clamp(max=cfg.l - 1)) == _at(s["ep"], l))
    )


def fenced_follower_fetch(cfg: Config):
    # FencedFollowerFetch (Kip320.tla:49-56)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        f, l = c // cfg.n, c % cfg.n
        off = _at(s["end"], f)
        enabled = (
            _following_epoch(s, l, f) & (off < cfg.l) & (off < _at(s["end"], l))
        )
        return _out(s, n, enabled, kr._replicate(cfg, s, f, l, off, enabled))

    return Action("FencedFollowerFetch", n, kernel, writes=kr._REPLICATE_WRITES)


def fenced_leader_inc_high_watermark(cfg: Config):
    # FencedLeaderIncHighWatermark (Kip320.tla:63-70), kept literal: no
    # presumes guard of its own
    n = cfg.n

    def kernel(s):
        l = choices(s, n)
        hw = _at(s["hw"], l)
        has_off = hw < _at(s["end"], l)
        cond = _following_epoch_vec(s, l) & (_vec(s["end"]) > hw.unsqueeze(-1))
        enabled = has_off & kr._forall_isr(cfg, _at(s["isr"], l), cond)
        return _out(s, n, enabled, {
            "hw": _put(s["hw"], (hw + 1).clamp(max=cfg.l), l),
        })

    return Action("FencedLeaderIncHighWatermark", n, kernel, writes=frozenset({"hw"}))


def fenced_leader_shrink_isr(cfg: Config):
    # FencedLeaderShrinkIsr (Kip320.tla:78-85)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        in_isr = (f != l) & _member(isr_l, f)
        stale = ~_following_epoch(s, l, f) | (_at(s["end"], f) < _at(s["end"], l))
        ok, upd = kr._quorum_update(s, l, isr_l & ~_bit(f))
        return _out(s, n, in_isr & stale & ok, upd)

    return Action("FencedLeaderShrinkIsr", n, kernel, writes=kr._QUORUM_WRITES)


def fenced_leader_expand_isr(cfg: Config):
    # FencedLeaderExpandIsr (Kip320.tla:110-117), guarded by
    # HasFollowerReachedHighWatermark (:94-98) and
    # HasHighWatermarkReachedCurrentEpoch (:87-92)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        outside = ~_member(isr_l, f)
        hw = _at(s["hw"], l)
        follower_at_hw = (hw == 0) | (_at(s["end"], f) >= hw)
        ok, upd = kr._quorum_update(s, l, isr_l | _bit(f))
        enabled = (
            outside
            & _following_epoch(s, l, f)
            & follower_at_hw
            & _hw_at_epoch(cfg, s, l, hw)
            & ok
        )
        return _out(s, n, enabled, upd)

    return Action("FencedLeaderExpandIsr", n, kernel, writes=kr._QUORUM_WRITES)


def fenced_become_follower_and_truncate(cfg: Config):
    # FencedBecomeFollowerAndTruncate (Kip320.tla:134-148): fenced on the
    # target leader being active in the request's epoch (:142-143)
    n = cfg.n * (cfg.e + 1)
    trunc = kr.kip279_offset(cfg)

    def kernel(s):
        c = choices(s, n)
        r, e = c // (cfg.e + 1), c % (cfg.e + 1)
        l = _at(s["req_ldr"], e)
        lc = l.clamp(0, cfg.n - 1)
        enabled = (
            (l >= 0)
            & (lc != r)
            & (e > _at(s["ep"], r))
            & (_at(s["ldr"], lc) == lc)
            & (_at(s["ep"], lc) == e)
        )
        toff = trunc(s, lc, r)
        enabled = enabled & (toff <= _at(s["end"], r))
        toff = toff.clamp(0, cfg.l)
        rid, repoch, end = kr._truncate_log(cfg, s, r, toff)
        return _out(s, n, enabled, {
            "rid": rid,
            "repoch": repoch,
            "end": end,
            "ep": _put(s["ep"], e, r),
            "ldr": _put(s["ldr"], lc, r),
            "isr": _put(s["isr"], _at(s["req_isr"], e), r),
            "hw": _put(s["hw"], torch.minimum(toff, _at(s["hw"], r)), r),
        })

    return Action("FencedBecomeFollowerAndTruncate", n, kernel,
                  writes=kr._BECOME_FOLLOWER_WRITES)


# --------------------------------------------------------------------------
# Kip320FirstTry kernels (Kip320FirstTry.tla:49-157)
# --------------------------------------------------------------------------


def _caught_up_to_epoch(cfg, s, l, f, end_offset):
    # IsFollowerCaughtUpToLeaderEpoch (Kip320FirstTry.tla:49-57)
    base = (_at(s["ldr"], l) == l) & (_at(s["ldr"], f) == l)
    off = (end_offset - 1).clamp(0, cfg.l - 1)
    nonzero = (
        (end_offset > 0)
        & (end_offset <= _at(s["end"], l))
        & (end_offset <= _at(s["end"], f))
        & (_at(s["repoch"], f, off) == _at(s["repoch"], l, off))
    )
    return base & ((end_offset == 0) | nonzero)


def ft_follower_truncate(cfg: Config):
    # FollowerTruncate (Kip320FirstTry.tla:75-82), guarded by
    # FollowerNeedsTruncation (:64-69)
    n = cfg.n * cfg.n
    trunc = kr.kip279_offset(cfg)

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        base = (_at(s["ldr"], l) == l) & (_at(s["ldr"], f) == l)
        f_end = _at(s["end"], f)
        l_end = _at(s["end"], l)
        last = (f_end - 1).clamp(0, cfg.l - 1)
        epoch_mismatch = (
            (f_end > 0)
            & (f_end <= l_end)
            & (_at(s["repoch"], l, last) != _at(s["repoch"], f, last))
        )
        needs = (f_end > l_end) | epoch_mismatch
        toff = trunc(s, l, f)
        enabled = base & needs & (toff <= f_end)
        toff = toff.clamp(0, cfg.l)
        rid, repoch, end = kr._truncate_log(cfg, s, f, toff)
        return _out(s, n, enabled, {
            "rid": rid,
            "repoch": repoch,
            "end": end,
            "hw": _put(s["hw"], torch.minimum(toff, _at(s["hw"], f)), f),
        })

    return Action("FollowerTruncate", n, kernel, writes=kr._REPLICATE_WRITES)


def ft_improved_leader_inc_high_watermark(cfg: Config):
    # ImprovedLeaderIncHighWatermark (Kip320FirstTry.tla:90-97)
    n = cfg.n

    def kernel(s):
        l = choices(s, n)
        hw = _at(s["hw"], l)
        end_l = _at(s["end"], l)
        presumes = _at(s["ldr"], l) == l
        has_entry = hw < end_l
        off = hw.clamp(max=cfg.l - 1)
        # repoch[:, f, off] for every follower f: [B, n, N]
        repoch_at_off = _row(s["repoch"].transpose(1, 2), off)
        cond = (
            (_vec(s["ldr"]) == l.unsqueeze(-1))
            & (hw + 1 <= end_l).unsqueeze(-1)
            & ((hw + 1).unsqueeze(-1) <= _vec(s["end"]))
            & (repoch_at_off == _at(s["repoch"], l, off).unsqueeze(-1))
        )
        enabled = presumes & has_entry & kr._forall_isr(cfg, _at(s["isr"], l), cond)
        return _out(s, n, enabled, {
            "hw": _put(s["hw"], (hw + 1).clamp(max=cfg.l), l),
        })

    return Action("ImprovedLeaderIncHighWatermark", n, kernel, writes=frozenset({"hw"}))


def ft_follower_fetch(cfg: Config):
    # FollowerFetch (Kip320FirstTry.tla:103-111)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        f, l = c // cfg.n, c % cfg.n
        off = _at(s["end"], f)
        enabled = (
            _caught_up_to_epoch(cfg, s, l, f, off)
            & (off < cfg.l)
            & (off < _at(s["end"], l))
        )
        return _out(s, n, enabled, kr._replicate(cfg, s, f, l, off, enabled))

    return Action("FollowerFetch", n, kernel, writes=kr._REPLICATE_WRITES)


def ft_leader_shrink_isr(cfg: Config):
    # LeaderShrinkIsrBetterFencing (Kip320FirstTry.tla:114-120)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        in_isr = (f != l) & _member(isr_l, f)
        lagging = ~_caught_up_to_epoch(cfg, s, l, f, _at(s["end"], l))
        ok, upd = kr._quorum_update(s, l, isr_l & ~_bit(f))
        return _out(s, n, in_isr & lagging & ok, upd)

    return Action("LeaderShrinkIsrBetterFencing", n, kernel, writes=kr._QUORUM_WRITES)


def ft_leader_expand_isr(cfg: Config):
    # LeaderExpandIsrBetterFencing (Kip320FirstTry.tla:134-141)
    n = cfg.n * cfg.n

    def kernel(s):
        c = choices(s, n)
        l, f = c // cfg.n, c % cfg.n
        isr_l = _at(s["isr"], l)
        outside = ~_member(isr_l, f)
        hw = _at(s["hw"], l)
        caught = _caught_up_to_epoch(cfg, s, l, f, hw)
        ok, upd = kr._quorum_update(s, l, isr_l | _bit(f))
        return _out(s, n, outside & caught & _hw_at_epoch(cfg, s, l, hw) & ok, upd)

    return Action("LeaderExpandIsrBetterFencing", n, kernel, writes=kr._QUORUM_WRITES)


def ft_become_follower(cfg: Config):
    # BecomeFollower (Kip320FirstTry.tla:148-157): adopt the request's
    # state, keep the log and hw
    n = cfg.n * (cfg.e + 1)

    def kernel(s):
        c = choices(s, n)
        r, e = c // (cfg.e + 1), c % (cfg.e + 1)
        l = _at(s["req_ldr"], e)
        lc = l.clamp(0, cfg.n - 1)
        enabled = (l >= 0) & (lc != r) & (e > _at(s["ep"], r))
        return _out(s, n, enabled, {
            "ep": _put(s["ep"], e, r),
            "ldr": _put(s["ldr"], lc, r),
            "isr": _put(s["isr"], _at(s["req_isr"], e), r),
        })

    return Action("BecomeFollower", n, kernel, writes=frozenset({"ep", "ldr", "isr"}))


# --------------------------------------------------------------------------
# model factories
# --------------------------------------------------------------------------


def make_model(cfg: Config, invariants: Sequence[str] = DEFAULT_INVARIANTS) -> Model:
    """Kip320!Next (Kip320.tla:150-159)."""
    actions = [
        kr.controller_elect_leader(cfg),
        kr.controller_shrink_isr(cfg),
        kr.become_leader(cfg),
        fenced_leader_expand_isr(cfg),
        fenced_leader_shrink_isr(cfg),
        kr.leader_write(cfg),
        fenced_leader_inc_high_watermark(cfg),
        fenced_become_follower_and_truncate(cfg),
        fenced_follower_fetch(cfg),
    ]
    return Model(
        name=f"Kip320({cfg.n}r,L{cfg.l},R{cfg.r},E{cfg.e})",
        spec=kr.make_spec(cfg),
        init_states=lambda: [kr.init_state(cfg)],
        actions=actions,
        invariants=invariant_kernels(cfg, invariants),
        decode=kr.make_decode(cfg),
        meta={"variant": "Kip320", "cfg": cfg},
    )


def make_first_try_model(
    cfg: Config, invariants: Sequence[str] = DEFAULT_INVARIANTS
) -> Model:
    """Kip320FirstTry!Next (Kip320FirstTry.tla:159-169)."""
    actions = [
        kr.controller_elect_leader(cfg),
        kr.controller_shrink_isr(cfg),
        kr.become_leader(cfg),
        ft_leader_expand_isr(cfg),
        ft_leader_shrink_isr(cfg),
        kr.leader_write(cfg),
        ft_improved_leader_inc_high_watermark(cfg),
        ft_become_follower(cfg),
        ft_follower_fetch(cfg),
        ft_follower_truncate(cfg),
    ]
    return Model(
        name=f"Kip320FirstTry({cfg.n}r,L{cfg.l},R{cfg.r},E{cfg.e})",
        spec=kr.make_spec(cfg),
        init_states=lambda: [kr.init_state(cfg)],
        actions=actions,
        invariants=invariant_kernels(cfg, invariants),
        decode=kr.make_decode(cfg),
        meta={"variant": "Kip320FirstTry", "cfg": cfg},
    )


# ==========================================================================
# oracle transcription
# ==========================================================================


def _o_following_epoch(s, l, f):
    # IsFollowingLeaderEpoch (Kip320.tla:39-42)
    _, rstates, *_ = s
    return (
        rstates[l][2] == l and rstates[f][2] == l and rstates[f][1] == rstates[l][1]
    )


def o_fenced_follower_fetch(cfg: Config):
    # Kip320.tla:49-56
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for f in range(cfg.n):
            for l in range(cfg.n):
                if not _o_following_epoch(s, l, f):
                    continue
                off = len(logs[f])
                if off >= cfg.l or off >= len(logs[l]):
                    continue
                new_logs = logs[:f] + (logs[f] + (logs[l][off],),) + logs[f + 1 :]
                hwf = min(rstates[l][0], off + 1)
                _, epf, ldrf, isrf = rstates[f]
                new_rs = rstates[:f] + ((hwf, epf, ldrf, isrf),) + rstates[f + 1 :]
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FencedFollowerFetch", successors)


def o_fenced_leader_inc_hw(cfg: Config):
    # Kip320.tla:63-70
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for l in range(cfg.n):
            hw, ep, ldr, isr = rstates[l]
            if hw >= len(logs[l]):
                continue
            if all(
                _o_following_epoch(s, l, f) and len(logs[f]) > hw for f in isr
            ):
                new_rs = rstates[:l] + ((hw + 1, ep, ldr, isr),) + rstates[l + 1 :]
                yield (logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FencedLeaderIncHighWatermark", successors)


def o_fenced_leader_shrink_isr(cfg: Config):
    # Kip320.tla:78-85
    def successors(s):
        logs, rstates, *_ = s
        for l in range(cfg.n):
            isr = rstates[l][3]
            for f in sorted(isr - {l}):
                if (not _o_following_epoch(s, l, f)) or len(logs[f]) < len(logs[l]):
                    t = kr._o_quorum_update(s, l, isr - {f})
                    if t is not None:
                        yield t

    return OracleAction("FencedLeaderShrinkIsr", successors)


def _o_hw_reached_epoch(s, l):
    # HasHighWatermarkReachedCurrentEpoch (Kip320.tla:87-92)
    logs, rstates, *_ = s
    hw = rstates[l][0]
    if hw == len(logs[l]):
        return True
    return hw < len(logs[l]) and logs[l][hw][1] == rstates[l][1]


def o_fenced_leader_expand_isr(cfg: Config):
    # Kip320.tla:110-117
    def successors(s):
        logs, rstates, *_ = s
        for l in range(cfg.n):
            hw, _, _, isr = rstates[l]
            for f in range(cfg.n):
                if f in isr:
                    continue
                if not _o_following_epoch(s, l, f):
                    continue
                if not (hw == 0 or len(logs[f]) >= hw):  # :94-98
                    continue
                if not _o_hw_reached_epoch(s, l):  # :87-92
                    continue
                t = kr._o_quorum_update(s, l, isr | {f})
                if t is not None:
                    yield t

    return OracleAction("FencedLeaderExpandIsr", successors)


def o_fenced_become_follower_and_truncate(cfg: Config):
    # Kip320.tla:134-148
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for (e, l, risr) in reqs:
            if l == NONE:
                continue
            for r in range(cfg.n):
                if r == l or e <= rstates[r][1]:
                    continue
                if rstates[l][2] != l or rstates[l][1] != e:  # :142-143
                    continue
                toff = kr.o_kip279_offset(cfg, s, l, r)
                if toff > len(logs[r]):
                    continue
                new_hw = min(toff, rstates[r][0])
                new_logs = logs[:r] + (logs[r][:toff],) + logs[r + 1 :]
                new_rs = rstates[:r] + ((new_hw, e, l, risr),) + rstates[r + 1 :]
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FencedBecomeFollowerAndTruncate", successors)


def _o_caught_up_to_epoch(cfg, s, l, f, end_offset):
    # Kip320FirstTry.tla:49-57
    logs, rstates, *_ = s
    if rstates[l][2] != l or rstates[f][2] != l:
        return False
    if end_offset == 0:
        return True
    off = end_offset - 1
    return (
        end_offset <= len(logs[l])
        and end_offset <= len(logs[f])
        and logs[f][off][1] == logs[l][off][1]
    )


def o_ft_follower_truncate(cfg: Config):
    # Kip320FirstTry.tla:64-82
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for l in range(cfg.n):
            for f in range(cfg.n):
                if rstates[l][2] != l or rstates[f][2] != l:
                    continue
                f_end = len(logs[f])
                mismatch = (
                    f_end > 0
                    and f_end <= len(logs[l])
                    and logs[l][f_end - 1][1] != logs[f][f_end - 1][1]
                )
                if not (f_end > len(logs[l]) or mismatch):
                    continue
                toff = kr.o_kip279_offset(cfg, s, l, f)
                if toff > f_end:
                    continue
                new_logs = logs[:f] + (logs[f][:toff],) + logs[f + 1 :]
                hwf, epf, ldrf, isrf = rstates[f]
                new_rs = (
                    rstates[:f] + ((min(toff, hwf), epf, ldrf, isrf),) + rstates[f + 1 :]
                )
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FollowerTruncate", successors)


def o_ft_improved_inc_hw(cfg: Config):
    # Kip320FirstTry.tla:90-97
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for l in range(cfg.n):
            hw, ep, ldr, isr = rstates[l]
            if ldr != l or hw >= len(logs[l]):
                continue
            if all(_o_caught_up_to_epoch(cfg, s, l, f, hw + 1) for f in isr):
                new_rs = rstates[:l] + ((hw + 1, ep, ldr, isr),) + rstates[l + 1 :]
                yield (logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("ImprovedLeaderIncHighWatermark", successors)


def o_ft_follower_fetch(cfg: Config):
    # Kip320FirstTry.tla:103-111
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for f in range(cfg.n):
            for l in range(cfg.n):
                off = len(logs[f])
                if not _o_caught_up_to_epoch(cfg, s, l, f, off):
                    continue
                if off >= cfg.l or off >= len(logs[l]):
                    continue
                new_logs = logs[:f] + (logs[f] + (logs[l][off],),) + logs[f + 1 :]
                hwf = min(rstates[l][0], off + 1)
                _, epf, ldrf, isrf = rstates[f]
                new_rs = rstates[:f] + ((hwf, epf, ldrf, isrf),) + rstates[f + 1 :]
                yield (new_logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("FollowerFetch", successors)


def o_ft_leader_shrink(cfg: Config):
    # Kip320FirstTry.tla:114-120
    def successors(s):
        logs, rstates, *_ = s
        for l in range(cfg.n):
            isr = rstates[l][3]
            for f in sorted(isr - {l}):
                if not _o_caught_up_to_epoch(cfg, s, l, f, len(logs[l])):
                    t = kr._o_quorum_update(s, l, isr - {f})
                    if t is not None:
                        yield t

    return OracleAction("LeaderShrinkIsrBetterFencing", successors)


def o_ft_leader_expand(cfg: Config):
    # Kip320FirstTry.tla:122-141
    def successors(s):
        logs, rstates, *_ = s
        for l in range(cfg.n):
            hw, _, _, isr = rstates[l]
            for f in range(cfg.n):
                if f in isr:
                    continue
                if not _o_caught_up_to_epoch(cfg, s, l, f, hw):
                    continue
                if not _o_hw_reached_epoch(s, l):
                    continue
                t = kr._o_quorum_update(s, l, isr | {f})
                if t is not None:
                    yield t

    return OracleAction("LeaderExpandIsrBetterFencing", successors)


def o_ft_become_follower(cfg: Config):
    # Kip320FirstTry.tla:148-157
    def successors(s):
        logs, rstates, nrid, nep, reqs, quorum = s
        for (e, l, risr) in reqs:
            if l == NONE:
                continue
            for r in range(cfg.n):
                if r == l or e <= rstates[r][1]:
                    continue
                hwf = rstates[r][0]
                new_rs = rstates[:r] + ((hwf, e, l, risr),) + rstates[r + 1 :]
                yield (logs, new_rs, nrid, nep, reqs, quorum)

    return OracleAction("BecomeFollower", successors)


def make_oracle(cfg: Config, invariants: Sequence[str] = DEFAULT_INVARIANTS) -> OracleModel:
    actions = [
        kr.o_controller_elect_leader(cfg),
        kr.o_controller_shrink_isr(cfg),
        kr.o_become_leader(cfg),
        o_fenced_leader_expand_isr(cfg),
        o_fenced_leader_shrink_isr(cfg),
        kr.o_leader_write(cfg),
        o_fenced_leader_inc_hw(cfg),
        o_fenced_become_follower_and_truncate(cfg),
        o_fenced_follower_fetch(cfg),
    ]
    return OracleModel(
        name="Kip320-oracle",
        init_states=lambda: [kr.o_init(cfg)],
        actions=actions,
        invariants=_invariant_oracles(cfg, invariants),
        meta={"variant": "Kip320", "cfg": cfg},
    )


def make_first_try_oracle(
    cfg: Config, invariants: Sequence[str] = DEFAULT_INVARIANTS
) -> OracleModel:
    actions = [
        kr.o_controller_elect_leader(cfg),
        kr.o_controller_shrink_isr(cfg),
        kr.o_become_leader(cfg),
        o_ft_leader_expand(cfg),
        o_ft_leader_shrink(cfg),
        kr.o_leader_write(cfg),
        o_ft_improved_inc_hw(cfg),
        o_ft_become_follower(cfg),
        o_ft_follower_fetch(cfg),
        o_ft_follower_truncate(cfg),
    ]
    return OracleModel(
        name="Kip320FirstTry-oracle",
        init_states=lambda: [kr.o_init(cfg)],
        actions=actions,
        invariants=_invariant_oracles(cfg, invariants),
        meta={"variant": "Kip320FirstTry", "cfg": cfg},
    )
