"""Per-chunk stages of the level loop, and the candidate order (PyTorch).

Counterpart of the stage helpers of ``kafka_specification_tpu/engine/
pipeline.py`` and of its two per-chunk pipelines, ``legacy`` and ``fused``.
Each frontier chunk goes through

  1. expand     every action kernel on every (state, choice) cell at once
  2. squeeze    the enabled cells, gathered and packed, in candidate order
  3. fingerprint  (hi, lo) of each packed row (kernel K1 on the card)
  4. dedup      in-batch and visited-set novelty, by the visited backend
                (``sorted_dedup_stage`` here for the sorted set; the hash
                table in ``engine/bfs.py``)
  5. invariants on the chunk being expanded

**The candidate order is the only knob-dependent input to the result**:
it decides which copy of a duplicate wins, and so the parents, actions
and trace.  The JAX package has two orders, and this module gives the
same two (``compacts``):

- below the compact gate, the full lattice's state-major order: a cell's
  rank is ``state * C + column``, columns in action order;
- where ``compact_shift > 0``, ``bucket >= compact_gate`` and
  ``bucket >> compact_shift >= 1``: action-major order, state then
  choice within an action (the order of the JAX legacy compact path and
  of every fused chunk).

In the JAX package the legacy and fused pipelines differ only in how XLA
programs are cut (one program per chunk with a pass per action, against a
guard program, host compaction and one update program); they give the
same result.  The port's action kernels already evaluate every cell in one
batched call, so one implementation (``run_chunk``) serves both names.

Buffers are sized at the exact enabled counts.  XLA compiles fixed shapes,
so the JAX package sizes its compact buffers by a policy
(``AdaptiveCompact``: a uniform 1/2^shift width, measured per-action
widths after an overflow; ``PooledWidths``: a half-octave ladder) and
re-runs a chunk whose buffer overflows.  The squeeze keeps the order, so
those widths change no result, and eager PyTorch needs none of them: here
a buffer cannot overflow and there is no escalation ladder.  Not followed:
with ``KSPEC_ADAPTIVE_COMPACT=0`` a JAX legacy chunk that overflows twice
falls back to the full lattice's state-major order for that chunk; the
port keeps action-major order above the gate whatever the environment.

The packer runs on the enabled cells only (about 6% of the lattice on
Kip320), in both orders; state-major order is one sort of the cells'
lattice ranks after packing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.base import Model
from ..ops import dedup
from ..ops.cuda_fingerprint import fingerprint
from ..ops.fingerprint import fingerprint_lanes


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def compacts(bucket: int, compact_shift: int, compact_gate: int) -> bool:
    """True where a chunk of `bucket` rows takes action-major order (the
    JAX ``FusedPipeline._gate`` and ``AdaptiveCompact.widths_for`` /
    ``_Step.norm_widths`` rule)."""
    return compact_shift > 0 and bucket >= compact_gate and (bucket >> compact_shift) >= 1


def grow_visited(vkeys: torch.Tensor, need: int) -> torch.Tensor:
    """The sorted visited set grown to the next power of two >= `need`,
    padded with the sentinel's order key."""
    pad = torch.full((next_pow2(need) - vkeys.shape[0],), dedup.PAD,
                     dtype=torch.int64, device=vkeys.device)
    return torch.cat([vkeys, pad])


def invariant_stage(model: Model, states: dict):
    """First violated invariant on the chunk, in model order, as
    (name, first row), or None."""
    for inv in model.invariants:
        bad = ~inv.pred(states)
        if bool(bad.any()):
            return inv.name, int(torch.argmax(bad.to(torch.uint8)))
    return None


def expand_stage(model: Model, states: dict):
    """-> (enabled bool[B, C] before the constraint, [(enabled[B, n_a],
    next fields[B, n_a, ...]) per action] with the constraint ANDed in).
    The first mask is the one deadlock reads: a state is deadlocked when no
    action's guard holds, whatever the constraint prunes."""
    parts = [a.kernel(states) for a in model.actions]
    en_pre = torch.cat([en for en, _ in parts], dim=1)
    if model.constraint is not None:
        parts = [(en & model.constraint(nxt), nxt) for en, nxt in parts]
    return en_pre, parts


def squeeze_stage(spec, parts, action_major: bool):
    """The enabled cells -> (rows int64[N, K], parent int64[N] chunk-local
    state index, act int64[N] action id), in candidate order."""
    fields = {f.name: [] for f in spec.fields}
    parent, act, rank = [], [], []
    C = sum(en.shape[1] for en, _ in parts)
    col = 0
    for i, (en, nxt) in enumerate(parts):
        n = en.shape[1]
        idx = en.reshape(-1).nonzero().squeeze(1)
        s, c = idx // n, idx % n
        for name, v in nxt.items():
            fields[name].append(v[s, c])
        parent.append(s)
        act.append(torch.full_like(s, i))
        if not action_major:
            rank.append(s * C + col + c)
        col += n
    rows = spec.pack({name: torch.cat(v) for name, v in fields.items()})
    parent, act = torch.cat(parent), torch.cat(act)
    if not action_major:
        perm = torch.sort(torch.cat(rank)).indices
        rows, parent, act = rows[perm], parent[perm], act[perm]
    return rows, parent, act


def fp_stage(spec, rows: torch.Tensor):
    """(hi, lo) fingerprints of packed rows: the state itself where it fits
    64 bits, else murmur3, by kernel K1 on a CUDA tensor."""
    if spec.exact64:
        return fingerprint_lanes(rows, exact=True)
    return fingerprint(rows, torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device))


def sorted_dedup_stage(okeys: torch.Tensor, vkeys: torch.Tensor, vn: int):
    """Stage 4 of the sorted backend: dedup against the sorted visited set
    and merge the new keys into it.  okeys: order keys of the chunk's
    candidates, in candidate order.  The stable sort puts the first copy of
    each key (in candidate order) first; a key is new when it is that first
    copy and not in the set.

    -> (winners int64[new_n]: candidate indices of the new states in KEY
    order, the merged set at vkeys' capacity, its size)."""
    sk, order = torch.sort(okeys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seen, rank = dedup.rank_sorted(vkeys, vn, sk)
    sel = (first & ~seen).nonzero().squeeze(1)
    vkeys, vn = dedup.merge_ranked(vkeys, vn, sk[sel], rank[sel], vkeys.shape[0])
    return order[sel], vkeys, vn


class Chunk(NamedTuple):
    """One chunk's outcome: a verdict (frontier index, invariant name), or
    its enabled candidates in candidate order with their fingerprints, and
    (when asked for) the enabled cells of each action, int64[A]."""

    verdict: Optional[tuple]
    rows: Optional[torch.Tensor] = None
    parent: Optional[torch.Tensor] = None
    act: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    act_en: Optional[torch.Tensor] = None


def run_chunk(model: Model, piece: torch.Tensor, action_major: bool, check_deadlock: bool,
              check_invariants: bool, enablement: bool) -> Chunk:
    """Stages 1-3 and 5 of one chunk of frontier rows, int64[rows, K], in
    the candidate order `action_major` selects (``compacts``).  Serves the
    "legacy" and "fused" pipelines alike (module docstring).  Stage 5 runs
    when `check_invariants`; `enablement` counts each action's enabled
    cells after the constraint (for the per-level stats)."""
    states = model.spec.unpack(piece)
    if check_invariants:
        bad = invariant_stage(model, states)
        if bad is not None:
            return Chunk((bad[1], bad[0]))
    en_pre, parts = expand_stage(model, states)
    if check_deadlock:
        dead = ~en_pre.any(dim=1)
        if bool(dead.any()):
            return Chunk((int(torch.argmax(dead.to(torch.uint8))), "Deadlock"))
    act_en = torch.stack([e.sum() for e, _ in parts]) if enablement else None
    rows, parent, act = squeeze_stage(model.spec, parts, action_major)
    hi, lo = fp_stage(model.spec, rows)
    return Chunk(None, rows, parent, act, hi, lo, act_en)
