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

``run_chunk`` is the chunk's *dispatch*, the counterpart of the JAX
package's ``run_chunk_staged``: it does the host reads the squeeze cannot
do without (the invariant flags, the deadlock flag, the exact enabled
counts), queues the pack and K1 on the card's stream, issues the
device-to-host copies the commit needs into page-locked buffers
(``HostSlots``) and records an event after them.  Its
``StagedChunk.finalize`` waits on that event alone and returns the
chunk's ``Chunk``.  The level loop (``engine/bfs.py``) dispatches chunk
k+1 before it commits chunk k, so chunk k's host commit runs while the
card finishes chunk k+1's tail; a plain ``.cpu()`` in the commit would
wait for every kernel queued ahead of it, chunk k+1's included.

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

The third pipeline, "device" (``DevicePipeline``, below), runs every
gated chunk of a level at fixed shapes with no host read between chunks;
it reads the host once a level and gives the same result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import Model
from ..ops import dedup, devlevel
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


# kspec: traced
def invariant_flags(model: Model, states: dict, valid: Optional[torch.Tensor] = None):
    """Stage 5 with no host read: (hit bool[], index of the first violated
    invariant in model order int64[], its first row int64[]).  Rows
    outside `valid` violate nothing.  Needs at least one invariant."""
    bad = torch.stack([~inv.pred(states) for inv in model.invariants])
    if valid is not None:
        bad = bad & valid
    inv_any = bad.any(dim=1)
    i = torch.argmax(inv_any.to(torch.uint8))
    row = torch.argmax(bad.to(torch.uint8), dim=1).gather(0, i.view(1))[0]
    return inv_any.any(), i, row


def invariant_stage(model: Model, states: dict):
    """First violated invariant on the chunk, in model order, as
    (name, first row), or None: ``invariant_flags`` and one host read."""
    if not model.invariants:
        return None
    hit, i, row = torch.stack([h.to(torch.int64) for h in invariant_flags(model, states)]).tolist()
    return (model.invariants[i].name, row) if hit else None


# kspec: traced
def expand_stage(model: Model, states: dict):
    """-> ([enabled bool[B, n_a] before the constraint], [(enabled[B, n_a],
    next fields[B, n_a, ...]) with the constraint ANDed in]), per action.
    The first masks are the ones deadlock reads (``deadlock_rows``)."""
    parts = [a.kernel(states) for a in model.actions]
    en_pre = [en for en, _ in parts]
    if model.constraint is not None:
        parts = [(en & model.constraint(nxt), nxt) for en, nxt in parts]
    return en_pre, parts


# kspec: traced
def deadlock_rows(en_pre, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[B]: the rows on which no action's guard holds, whatever the
    constraint prunes (rows outside `valid` are not deadlocked)."""
    dead = ~torch.cat(en_pre, dim=1).any(dim=1)
    return dead if valid is None else dead & valid


# kspec: traced
def first_copies(okeys: torch.Tensor):
    """The stable sort of a chunk's order keys: -> (sorted keys, candidate
    index of each, bool first copy of its key in candidate order)."""
    sk, order = torch.sort(okeys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return sk, order, first


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
    sk, order, first = first_copies(okeys)
    seen, rank = dedup.rank_sorted(vkeys, vn, sk)
    sel = (first & ~seen).nonzero().squeeze(1)
    vkeys, vn = dedup.merge_ranked(vkeys, vn, sk[sel], rank[sel], vkeys.shape[0])
    return order[sel], vkeys, vn


class Chunk(NamedTuple):
    """One chunk's outcome: a verdict (frontier index, invariant name), or
    its enabled candidates in candidate order with their fingerprints, and
    (when asked for) the enabled cells of each action, int64[A].  The host
    copies asked of the dispatch: `keys`, the candidates' fingerprint pair
    keys (int64 bit patterns); `rows_h`, `parent_h`, `act_h`, their rows,
    chunk-local parents and actions (int64)."""

    verdict: Optional[tuple]
    rows: Optional[torch.Tensor] = None
    parent: Optional[torch.Tensor] = None
    act: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    act_en: Optional[torch.Tensor] = None
    keys: Optional[np.ndarray] = None
    rows_h: Optional[np.ndarray] = None
    parent_h: Optional[np.ndarray] = None
    act_h: Optional[np.ndarray] = None


class HostSlots:
    """Page-locked host buffers for the staged chunks' device-to-host
    copies: one set a staging slot (the level loop stages at most two
    chunks), each buffer grown (at least doubled) to hold the largest copy
    it took, and never shrunk.  A slot is reused two dispatches later,
    after its chunk was committed, and the commit keeps no view of it
    (every host array it passes on is a fancy-indexed copy).  On the CPU
    there is no copy: the host arrays are views of the chunk's tensors."""

    SLOTS = 2

    def __init__(self):
        self._bufs = [{} for _ in range(self.SLOTS)]
        self._next = 0

    def take(self) -> dict:
        """The next slot's buffers, in turn."""
        slot = self._bufs[self._next]
        self._next = (self._next + 1) % self.SLOTS
        return slot

    @staticmethod
    def copy(slot: dict, name: str, t: torch.Tensor) -> np.ndarray:
        """Issue the copy of `t` into the slot's buffer `name` (grown if
        too small) on the current stream; -> its host view, valid once the
        chunk's event has completed."""
        if t.device.type != "cuda":
            return t.numpy()
        n = t.numel()
        buf = slot.get(name)
        if buf is None or buf.numel() < n or buf.dtype != t.dtype:
            # doubled at least, so that a run's few growths amortize the
            # page-locked allocation
            old = 0 if buf is None else buf.numel()
            buf = slot[name] = torch.empty(max(n, 2 * old, 1), dtype=t.dtype, pin_memory=True)
        view = buf[:n].view(t.shape)
        view.copy_(t, non_blocking=True)
        return view.numpy()


class StagedChunk:
    """A dispatched chunk: its verdict (known at dispatch), or its outputs
    on the card with their host copies in flight behind `event`."""

    def __init__(self, chunk: Chunk, event=None):
        self._chunk = chunk
        self._event = event

    @property
    def verdict(self) -> Optional[tuple]:
        return self._chunk.verdict

    def finalize(self) -> Chunk:
        """Wait for the chunk's host copies (their event, nothing queued
        after it) and return the chunk."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._chunk


def run_chunk(model: Model, piece: torch.Tensor, action_major: bool, check_deadlock: bool,
              check_invariants: bool, enablement: bool, host: tuple = (),
              slots: Optional[HostSlots] = None) -> StagedChunk:
    """Dispatch stages 1-3 and 5 of one chunk of frontier rows, int64[rows,
    K], in the candidate order `action_major` selects (``compacts``).
    Serves the "legacy" and "fused" pipelines alike (module docstring).
    Stage 5 runs when `check_invariants`; `enablement` counts each action's
    enabled cells after the constraint (for the per-level stats).  `host`
    names the host copies the commit needs ("keys", "rows": the Chunk
    fields), issued last, into `slots` on the card.  -> the staged chunk;
    its ``finalize()`` gives the ``Chunk``."""
    states = model.spec.unpack(piece)
    if check_invariants:
        bad = invariant_stage(model, states)
        if bad is not None:
            return StagedChunk(Chunk((bad[1], bad[0])))
    en_pre, parts = expand_stage(model, states)
    if check_deadlock:
        dead = deadlock_rows(en_pre)
        if bool(dead.any()):
            return StagedChunk(Chunk((int(torch.argmax(dead.to(torch.uint8))), "Deadlock")))
    act_en = torch.stack([e.sum() for e, _ in parts]) if enablement else None
    rows, parent, act = squeeze_stage(model.spec, parts, action_major)
    hi, lo = fp_stage(model.spec, rows)
    copies = {}
    if host:
        slot = slots.take()
        if "keys" in host:
            copies["keys"] = HostSlots.copy(slot, "keys", dedup.pair_key(hi, lo))
        if "rows" in host:
            for name, t in (("rows_h", rows), ("parent_h", parent), ("act_h", act)):
                copies[name] = HostSlots.copy(slot, name, t)
    event = None
    if copies and rows.device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return StagedChunk(Chunk(None, rows, parent, act, hi, lo, act_en, **copies), event)


# kspec: traced
def fp_masked(spec, rows: torch.Tensor, valid: torch.Tensor):
    """fp_stage with a row mask: the sentinel pair for invalid rows."""
    if spec.exact64:
        hi, lo = fingerprint_lanes(rows, exact=True)
        return torch.where(valid, hi, dedup.SENT), torch.where(valid, lo, dedup.SENT)
    return fingerprint(rows, valid)


# --------------------------------------------------------------------------
# the device-resident level pipeline ("device")
# --------------------------------------------------------------------------


def round256(w: int) -> int:
    return -(-int(w) // 256) * 256


class PooledWidths:
    """Per-action candidate widths of a level's chunks: the JAX package's
    pooled half-octave ladder (``PooledWidths`` and ``_Step.norm_widths``
    there).  Each action's width is the smallest rung {0.75 * 2^k, 2^k},
    rounded to 256, at or above max(256, this count, the run's high-water
    density x bucket x 1.35), capped at the action's full lattice."""

    HEADROOM = 1.35

    def __init__(self, actions):
        self.actions = list(actions)
        self.hw = np.zeros(len(self.actions), np.float64)  # density high water

    @staticmethod
    def _rung(need: int) -> int:
        p = next_pow2(need)
        q = round256((3 * p) >> 2)
        return q if q >= need else round256(p)

    def widths_for(self, bucket: int, counts) -> tuple:
        """Widths for a chunk of `bucket` rows, after folding `counts`
        (per-action guard counts of a chunk) into the high water."""
        counts = np.asarray(counts, np.float64)
        self.hw = np.maximum(self.hw, counts / max(bucket, 1))
        out = []
        for a, hw, count in zip(self.actions, self.hw, counts):
            need = max(256, int(count), int(self.HEADROOM * hw * bucket))
            w = min(round256(bucket * a.n_choices), self._rung(need))
            out.append(min(round256(max(1, w)), bucket * a.n_choices))
        return tuple(out)


def device_hull_fallback(model: Model) -> Optional[str]:
    """The device pipeline's hard precondition: every field's proven
    reachable-value hull lies inside its declared packed range.  Stricter
    than the encoding gate on purpose (the gate can be turned off with
    KSPEC_ANALYZE=0, this cannot): no host check runs between a level's
    chunks, so the packer's no-truncation property must be proven.
    -> None when proven, else the reason (the JAX package's wording)."""
    from ..analysis import field_hulls
    from ..analysis.interval import AnalysisUnsupported

    try:
        hulls = field_hulls(model, strict=True)
    except AnalysisUnsupported as e:
        return f"no proven field hulls ({e})"
    except Exception as e:  # noqa: BLE001 -- never break checking
        return f"field-hull analysis failed ({type(e).__name__}: {e})"[:200]
    bad = [f.name for f in model.spec.fields
           if hulls[f.name][0] < f.lo or hulls[f.name][1] > f.hi]
    if bad:
        return (f"field hull escapes the declared packed range for {bad} "
                f"(encoding-unsound model; KSPEC_ANALYZE=0?)")
    return None


# kspec: traced
def chunk_novelty(okeys: torch.Tensor, lkeys: torch.Tensor, vkeys: Optional[torch.Tensor]):
    """Stage 4 of a level chunk: the stable sort of the chunk's order keys
    (the sentinel's, PAD, for invalid rows), first occurrences, and
    novelty against the level-new set `lkeys` and, in device mode, the
    read-only visited set `vkeys` (both fixed-capacity, PAD-tailed).
    -> (sorted keys, candidate index of each, is_new, rank in lkeys)."""
    sk, order, first = first_copies(okeys)
    seen_l, rank_l = dedup.rank_full(lkeys, sk)
    is_new = first & (sk != dedup.PAD) & ~seen_l
    if vkeys is not None:
        is_new &= ~dedup.rank_full(vkeys, sk)[0]
    return sk, order, is_new, rank_l


# kspec: traced
def candidate_dedup_stage(order: torch.Tensor, take_sorted: torch.Tensor):
    """The host mode's winner emission: the novelty decided in key order
    (the stable sort's first copy, the row the serial host insert keeps),
    emitted in CANDIDATE order, the order the serial per-chunk host path
    hands rows to the fingerprint set.  -> (taken, rank among the chunk's
    winners), per candidate."""
    take_c = torch.zeros_like(take_sorted).scatter_(0, order, take_sorted)
    return take_c, torch.cumsum(take_c, 0) - 1


# kspec: traced
def sorted_emit(order: torch.Tensor, take_sorted: torch.Tensor):
    """The device mode's winner emission, in KEY order (the sorted set's
    commit order).  -> (taken, rank among the chunk's winners), per
    candidate."""
    take_c = torch.zeros_like(take_sorted).scatter_(0, order, take_sorted)
    pos = torch.cumsum(take_sorted, 0) - 1
    return take_c, torch.empty_like(pos).scatter_(0, order, pos)


class LevelOut(NamedTuple):
    """A device level's committed outputs: its new states (rows, parents
    as frontier indices, action ids) in commit order, or a verdict
    (frontier index, invariant name); `keys` (host mode) are the rows'
    fingerprint pair keys; `lkeys` (device mode) their order keys,
    ascending, for the visited set's one merge, and `digest` their (count,
    xor, sum); `act_en` each action's enabled successors, `reads` the
    host reads it took."""

    verdict: Optional[tuple]
    rows: Optional[torch.Tensor]
    parent: Optional[torch.Tensor]
    act: Optional[torch.Tensor]
    keys: Optional[np.ndarray]
    lkeys: Optional[torch.Tensor]
    digest: Optional[tuple]
    act_en: list
    reads: int


class _Level:
    """The carried state of one dispatch of a level: its buffers, on the
    card, and what the chunks fold into them."""

    def __init__(self, pipe, frontier, handled, B, nc, widths, LN, vkeys):
        dev = frontier.device
        K = pipe.model.spec.num_lanes
        A = len(pipe.model.actions)
        self.B, self.nc, self.handled = B, nc, handled
        self.widths, self.LN, self.vkeys = widths, LN, vkeys
        self.T = sum(widths)
        fbuf = frontier[:handled]
        if nc * B > handled:
            fbuf = torch.cat([fbuf, fbuf.new_zeros((nc * B - handled, K))])
        self.fbuf = fbuf
        z = torch.zeros((), dtype=torch.int64, device=dev)
        self.false = torch.zeros((), dtype=torch.bool, device=dev)
        self.zero = z
        self.ar_B = torch.arange(B, device=dev)
        self.ar_lat = [torch.arange(B * a.n_choices, device=dev) for a in pipe.model.actions]
        self.ar_W = [torch.arange(w, device=dev) for w in widths]
        self.act_ids = torch.cat([torch.full((w,), i, dtype=torch.int64, device=dev)
                                  for i, w in enumerate(widths)])
        # outputs: LN rows and a dump row
        self.orows = torch.zeros((LN + 1, K), dtype=torch.int64, device=dev)
        self.opar = torch.zeros(LN + 1, dtype=torch.int64, device=dev)
        self.oact = torch.zeros(LN + 1, dtype=torch.int64, device=dev)
        self.okeys = torch.zeros(LN + 1, dtype=torch.int64, device=dev) if pipe.host_mode else None
        self.lkeys = torch.full((LN,), dedup.PAD, dtype=torch.int64, device=dev)
        self.on = z.clone()
        self.vkind, self.vinv, self.vidx = z.clone(), z.clone(), z.clone()
        self.ovf = self.false.clone()
        self.act_en = torch.zeros(A, dtype=torch.int64, device=dev)
        self.agmax = torch.zeros(A, dtype=torch.int64, device=dev)
        self.dig = devlevel.zero_digest(dev)


class DevicePipeline:
    """The device-resident level pipeline: every gated chunk of a level is
    queued on the card with no host read between chunks, and the host
    reads the level's outcome once (twice on an overflow re-dispatch).
    Counterpart of ``kafka_specification_tpu/engine/pipeline.py::
    DevicePipeline``, whose level is one ``lax.while_loop`` program.

    A chunk runs at fixed shapes: the expansion of every action kernel on
    the B-row chunk (padding rows masked out of every enabled mask, since
    a zero row unpacks to a state that may enable actions), a per-action
    compaction of the guard-enabled cells into a segment of fixed width
    (an exclusive cumsum gives each cell its slot, in action-major order,
    state then choice: the compact candidate order; cells past the width
    go to a dump slot and raise the overflow flag), the pack, K1, the
    stable sort, novelty against the level-new set (and, on the sorted
    ``device`` backend, the read-only visited set), the merge of the
    chunk's winners into the level-new set (``dedup.merge_full``), the
    appends of the winners' rows, parents and actions, and (device mode)
    the digest fold.  Verdicts ride on the card as (kind, invariant,
    frontier row) with the serial priority: invariants beat deadlock,
    an earlier chunk beats a later one, and a verdict chunk, like every
    chunk queued after it, commits nothing.

    Backends: ``device`` (the visited set is merged once per level, by
    rank, and the chain folds the level's digest) and ``host`` (deferred
    probe: the level's novel candidates come back in candidate order for
    one batched insert into the host set, and the chain folds the
    survivors).  ``device-hash`` degrades to the per-chunk ``fused`` path
    with the JAX package's reason.

    Widths change no result (the compaction keeps the candidate order).
    The policy is the JAX package's (``PooledWidths``, the level-new
    ladder of ``ops/devlevel.py``), so each level's widths, level-new
    capacity and the sorted set's growth, and with them
    ``stats["visited_capacity"]``, equal the JAX package's.  An overflow
    (a segment or the level-new set) re-dispatches the level once, at
    the exact per-action maxima it measured and the safe level-new
    bound, which cannot overflow.

    Divergence from the JAX package: it degrades to ``fused`` on ANY
    exception in a level (a compile failure, an allocation failure).  The
    port degrades only for reasons decided before anything is launched:
    the backend, unproven field hulls (``device_hull_fallback``), and a
    sub-gate tail chunk (``plan_level``).  A CUDA or kernel error inside a
    level raises.
    """

    name = "device"

    def __init__(self, model: Model, visited_backend: str, check_invariants: bool,
                 check_deadlock: bool, compact_shift: int, compact_gate: int):
        from ..pipeline_registry import backend_fallback_reason

        self.model = model
        self.check_invariants = check_invariants and bool(model.invariants)
        self.check_deadlock = check_deadlock
        self.compact_shift, self.compact_gate = compact_shift, compact_gate
        self.host_mode = visited_backend == "host"
        self.pool = PooledWidths(model.actions)
        self.ln_hw = 0  # the run's per-level new-state high water
        self.levels = 0  # levels run device-resident
        self.fallback = backend_fallback_reason("device", visited_backend)
        if self.fallback is None:
            self.fallback = device_hull_fallback(model)

    def _gate(self, bucket: int) -> bool:
        return compacts(bucket, self.compact_shift, self.compact_gate)

    def mark_fallback(self, reason: str, depth: int) -> None:
        """Leave the device path for the per-chunk one for the rest of the
        run, with the JAX package's `pipeline-fallback` event."""
        self.fallback = reason
        from ..obs import tracer as _obs

        _obs.event("pipeline-fallback", depth=depth, pipeline="device",
                   to="fused", error=reason)

    def plan_level(self, f_total: int, chunk: int, min_bucket: int):
        """-> (bucket, chunks, rows handled) when the level program serves
        (a prefix of) this level, else None: the JAX package's plan.  Full
        chunks run at bucket = chunk; a trailing partial chunk joins iff
        the serial loop would take the compact order for it, else it runs
        through the per-chunk path after the level (its state-major
        order is what the gate protects)."""
        if self.fallback is not None or f_total <= 0:
            return None
        if f_total <= chunk:
            B = next_pow2(max(f_total, min_bucket))
            return (B, 1, f_total) if self._gate(B) else None
        if not self._gate(chunk):
            return None
        n_full, rem = divmod(f_total, chunk)
        nc, handled = n_full, n_full * chunk
        if rem and self._gate(next_pow2(max(rem, min_bucket))):
            nc += 1
            handled = f_total
        return (chunk, nc, handled)

    def widths(self, B: int, counts=None) -> tuple:
        return self.pool.widths_for(B, np.zeros(len(self.model.actions)) if counts is None
                                    else counts)

    # kspec: traced
    def queue_level(self, frontier, handled: int, B: int, nc: int, widths: tuple, LN: int,
                    vkeys: Optional[torch.Tensor]) -> _Level:
        """Queue every chunk of one dispatch on the card; reads nothing
        back (the body is free of host synchronisation)."""
        st = _Level(self, frontier, handled, B, nc, widths, LN, vkeys)
        for i in range(nc):
            self._chunk(st, i)
        return st

    # kspec: traced
    def _chunk(self, st: _Level, i: int) -> None:
        model, spec = self.model, self.model.spec
        B, start = st.B, i * st.B
        fvalid = st.ar_B < min(B, st.handled - start)
        states = spec.unpack(st.fbuf[start : start + B])
        # stage 5: the first violated invariant (model order), its first row
        if self.check_invariants:
            inv_hit, inv_i, inv_row = invariant_flags(model, states, fvalid)
        else:
            inv_hit, inv_i, inv_row = st.false, st.zero, st.zero
        # stage 1: every action on every cell
        en_pre, parts = expand_stage(model, states)
        deadlocked = deadlock_rows(en_pre, fvalid)
        dl_hit = deadlocked.any() if self.check_deadlock else st.false
        # stage 2: per-action compaction of the guard-enabled cells
        fields = {f.name: [] for f in spec.fields}
        valid, parent, guard, a_en = [], [], [], []
        exp_ovf = st.false
        for ai, (a, (en, nxt), W) in enumerate(zip(model.actions, parts, st.widths)):
            g = (en_pre[ai] & fvalid[:, None]).reshape(-1)
            cnt = g.sum()
            guard.append(cnt)
            exp_ovf = exp_ovf | (cnt > W)
            slot = torch.where(g, torch.cumsum(g, 0) - 1, W).clamp(max=W)
            cidx = torch.zeros(W + 1, dtype=torch.int64, device=g.device)
            cidx = cidx.index_copy_(0, slot, st.ar_lat[ai])[:W]
            sidx, ch = cidx // a.n_choices, cidx % a.n_choices
            ok = en[sidx, ch] & (st.ar_W[ai] < cnt)
            for name, v in nxt.items():
                fields[name].append(v[sidx, ch])
            valid.append(ok)
            parent.append(sidx)
            a_en.append(ok.sum())
        rows = spec.pack({name: torch.cat(v) for name, v in fields.items()})
        valid = torch.cat(valid)
        parent = torch.cat(parent)
        # stage 3: fingerprints (K1)
        hi, lo = fp_masked(spec, rows, valid)
        # stage 4: novelty against the level-new set (and the visited set)
        sk, order, is_new, rank_l = chunk_novelty(dedup.order_key(hi, lo), st.lkeys, st.vkeys)
        new_n = is_new.sum()
        kind = torch.where(inv_hit, 1, torch.where(dl_hit, 2, 0))
        g_idx = torch.where(inv_hit, inv_row, torch.argmax(deadlocked.to(torch.uint8))) + start
        live = st.vkind == 0
        take = live & (kind != 0)
        commit = live & (kind == 0)
        ln_ovf = commit & (st.on + new_n > st.LN)
        commit_ok = commit & ~st.ovf & ~exp_ovf & ~ln_ovf
        app = is_new & commit_ok
        app_n = app.sum()
        # the winners, sorted, merged into the level-new set
        T = st.T
        pos = torch.where(app, torch.cumsum(app, 0) - 1, T)
        nk = torch.full((T + 1,), dedup.PAD, dtype=torch.int64, device=sk.device)
        nr = torch.zeros(T + 1, dtype=torch.int64, device=sk.device)
        nk.index_copy_(0, pos, sk)
        nr.index_copy_(0, pos, rank_l)
        st.lkeys = dedup.merge_full(st.lkeys, st.on, nk[:T], nr[:T], app_n)
        take_c, pos_c = (candidate_dedup_stage if self.host_mode else sorted_emit)(order, app)
        slots = devlevel.append_slots(pos_c, take_c, st.on, st.LN)
        devlevel.append_rows(st.orows, rows, slots)
        devlevel.append_vec(st.opar, parent + start, slots)
        devlevel.append_vec(st.oact, st.act_ids, slots)
        if self.host_mode:
            devlevel.append_vec(st.okeys, dedup.pair_key(hi, lo), slots)
        else:
            st.dig = devlevel.combine_digest(
                st.dig, devlevel.masked_digest(sk ^ dedup.TOP_BIT, app))
        st.on = st.on + app_n
        st.act_en = st.act_en + torch.where(commit_ok, torch.stack(a_en), 0)
        st.agmax = torch.where(live, torch.maximum(st.agmax, torch.stack(guard)), st.agmax)
        st.ovf = st.ovf | (live & (exp_ovf | ln_ovf))
        st.vkind = torch.where(take, kind, st.vkind)
        st.vinv = torch.where(take, inv_i, st.vinv)
        st.vidx = torch.where(take, g_idx, st.vidx)

    def read_level(self, st: _Level):
        """The level's one host read: flags, verdict, count, per-action
        maxima and enablement, digest, and (host mode) the winners' keys.
        -> (ovf, vkind, vinv, vidx, on, agmax, act_en, digest, keys)."""
        A = len(self.model.actions)
        head = torch.cat([
            torch.stack([st.ovf.to(torch.int64), st.vkind, st.vinv, st.vidx, st.on]),
            st.agmax, st.act_en, st.dig,
        ])
        if self.host_mode:
            head = torch.cat([head, st.okeys[: st.LN]])
        got = head.cpu().numpy()
        ovf, vkind, vinv, vidx, on = (int(v) for v in got[:5])
        agmax = got[5 : 5 + A]
        act_en = [int(v) for v in got[5 + A : 5 + 2 * A]]
        digest = devlevel.digest_ints(got[5 + 2 * A : 8 + 2 * A].tolist())
        keys = got[8 + 2 * A : 8 + 2 * A + on] if self.host_mode else None
        return bool(ovf), vkind, vinv, vidx, on, agmax, act_en, digest, keys

    def run_level(self, frontier: torch.Tensor, plan: tuple, visited) -> LevelOut:
        """Run one level (a prefix of `frontier`, as `plan` says) with at
        most one re-dispatch on overflow.  In device mode the sorted
        visited set (`visited`, read-only here) is grown first by the JAX
        package's rule, so its capacity follows the JAX package's."""
        B, nc, handled = plan
        NCp = next_pow2(nc)
        widths = self.widths(B)
        T = sum(widths)
        LN = devlevel.level_new_capacity(T, self.ln_hw, NCp * T)
        exact = False
        reads = 0
        while True:
            vkeys = None
            if not self.host_mode:
                visited.reserve(min(NCp * T, LN + T))
                vkeys = visited.keys
            st = self.queue_level(frontier, handled, B, nc, widths, LN, vkeys)
            ovf, vkind, vinv, vidx, on, agmax, act_en, digest, keys = self.read_level(st)
            reads += 1
            if ovf and vkind == 0:
                if exact:
                    raise RuntimeError(
                        "device level overflowed at its exact widths and safe bound")
                # re-dispatch once at the measured maxima and the safe bound
                widths = self.widths(B, agmax.astype(np.float64))
                T = sum(widths)
                LN = devlevel.level_new_bound(NCp * T)
                exact = True
                continue
            break
        self.pool.hw = np.maximum(self.pool.hw, agmax.astype(np.float64) / max(B, 1))
        self.levels += 1
        self.ln_hw = max(self.ln_hw, on)
        if vkind:
            name = self.model.invariants[vinv].name if vkind == 1 else "Deadlock"
            return LevelOut((vidx, name), None, None, None, None, None, None, act_en, reads)
        return LevelOut(None, st.orows[:on], st.opar[:on], st.oact[:on], keys,
                        None if self.host_mode else st.lkeys[:on], digest, act_en, reads)
