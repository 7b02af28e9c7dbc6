"""FiniteReplicatedLog: a bounded per-replica log state machine (PyTorch).

Counterpart of ``kafka_specification_tpu/models/finite_replicated_log.py``
(FiniteReplicatedLog.tla): the same encoding, end[N] in 0..L and
rec[N, L] in {Nil = -1} + 0..R-1, with truncated slots Nil-filled so the
dense array is canonical, and the same choice spaces:

  Append      (replica, record): offset forced to endOffset (:99-103)
  TruncateTo  (replica, offset): offset in 0..LogSize-1 (:105-109)
  ReplicateTo (from, to): offset forced to to's endOffset, record to
              from's record there (:111-113)

Each kernel works on every (state, choice) cell at once, with the batched
helpers of ``kafka_replication``.  FRL(3, 4, 1) has 125 states, FRL(2, 2, 2)
49.
"""

from __future__ import annotations

import torch

from ..ops.packing import Field, StateSpec
from ..oracle.interp import OracleAction, OracleModel
from .base import Action, Invariant, Model
from .kafka_replication import _at, _put

NIL = -1


def make_model(n_replicas: int, log_size: int, n_records: int, force_hashed: bool = False) -> Model:
    N, L, R = n_replicas, log_size, n_records
    spec = StateSpec(
        [Field("end", (N,), 0, L), Field("rec", (N, L), NIL, R - 1)],
        force_hashed=force_hashed,
    )

    def cells(s, n):
        return torch.arange(n, device=s["end"].device).unsqueeze(0)

    def append(s):
        c = cells(s, N * R)
        r, record = c // R, c % R
        end = _at(s["end"], r)
        enabled = end < L
        off = end.clamp(max=L - 1)
        rec = _put(s["rec"], torch.where(enabled, record, _at(s["rec"], r, off)), r, off)
        return enabled, {"end": _put(s["end"], torch.where(enabled, end + 1, end), r), "rec": rec}

    def truncate_to(s):
        c = cells(s, N * L)
        r, new_end = c // L, c % L
        end = _at(s["end"], r)
        enabled = new_end <= end
        # Nil-fill row r from new_end on (:108)
        dev = end.device
        drop = (
            enabled[..., None, None]
            & (torch.arange(N, device=dev).view(N, 1) == r[..., None, None])
            & (torch.arange(L, device=dev) >= new_end[..., None, None])
        )
        rec = torch.where(drop, NIL, s["rec"].unsqueeze(1))
        return enabled, {"end": _put(s["end"], torch.where(enabled, new_end, end), r), "rec": rec}

    def replicate_to(s):
        c = cells(s, N * (N - 1))
        src, d = c // (N - 1), c % (N - 1)
        dst = d + (d >= src).to(d.dtype)  # Replicas \ {src}
        off = _at(s["end"], dst)
        enabled = (off < L) & (off < _at(s["end"], src))
        offc = off.clamp(max=L - 1)
        record = torch.where(enabled, _at(s["rec"], src, offc), _at(s["rec"], dst, offc))
        rec = _put(s["rec"], record, dst, offc)
        return enabled, {"end": _put(s["end"], torch.where(enabled, off + 1, off), dst), "rec": rec}

    def type_ok(s):
        # TypeOk (:90-95): written slots hold records, unwritten slots Nil
        end, rec = s["end"], s["rec"]
        written = torch.arange(L, device=end.device) < end.unsqueeze(-1)
        ok_written = torch.where(written, (rec >= 0) & (rec < R), True).flatten(1).all(1)
        ok_unwritten = torch.where(written, True, rec == NIL).flatten(1).all(1)
        return ok_written & ok_unwritten & ((end >= 0) & (end <= L)).all(1)

    def decode(s):
        return tuple(tuple(int(x) for x in s["rec"][r][: int(s["end"][r])]) for r in range(N))

    return Model(
        name=f"FiniteReplicatedLog(N={N},L={L},R={R})",
        spec=spec,
        init_states=lambda: [{"end": [0] * N, "rec": [[NIL] * L for _ in range(N)]}],
        actions=[
            Action("Append", N * R, append, writes=frozenset({"end", "rec"})),
            Action("TruncateTo", N * L, truncate_to, writes=frozenset({"end", "rec"})),
            Action("ReplicateTo", N * (N - 1), replicate_to,
                   writes=frozenset({"end", "rec"})),
        ],
        invariants=[Invariant("TypeOk", type_ok)],
        decode=decode,
    )


def make_oracle(n_replicas: int, log_size: int, n_records: int) -> OracleModel:
    """Set-semantics transcription. State = tuple over replicas of the written
    record tuple (endOffset is its length; unwritten slots are implicit Nil,
    canonical per FiniteReplicatedLog.tla:105-109)."""
    N, L, R = n_replicas, log_size, n_records

    def append(s):
        # :99-103
        for r in range(N):
            if len(s[r]) < L:
                for record in range(R):
                    yield s[:r] + (s[r] + (record,),) + s[r + 1 :]

    def truncate(s):
        # :105-109; newEndOffset in Offsets = 0..L-1 (:37,117) and <= endOffset
        for r in range(N):
            for new_end in range(min(len(s[r]), L - 1) + 1):
                yield s[:r] + (s[r][:new_end],) + s[r + 1 :]

    def replicate(s):
        # :111-113, 118
        for src in range(N):
            for dst in range(N):
                if dst == src:
                    continue
                off = len(s[dst])
                if off < L and off < len(s[src]):
                    yield s[:dst] + (s[dst] + (s[src][off],),) + s[dst + 1 :]

    return OracleModel(
        name=f"FiniteReplicatedLog(N={N},L={L},R={R})",
        init_states=lambda: [tuple(() for _ in range(N))],  # :97
        actions=[
            OracleAction("Append", append),
            OracleAction("TruncateTo", truncate),
            OracleAction("ReplicateTo", replicate),
        ],
        # TypeOk (:90-95): endOffset bounded; written slots hold LogRecords
        # (unwritten slots are implicitly Nil in this representation, which is
        # the canonical form TruncateTo maintains, :108)
        invariants=[
            (
                "TypeOk",
                lambda s: all(
                    len(log) <= L and all(0 <= rec < R for rec in log) for log in s
                ),
            )
        ],
    )
