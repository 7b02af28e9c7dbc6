"""Mesh-sharded BFS on torch.distributed: the per-chunk path (PyTorch).

Counterpart of ``kafka_specification_tpu/parallel/sharded.py::
check_sharded`` on its per-chunk step, with its overlap and storage legs
(below).  The frontier and the fingerprint set are sharded over D shards
(``multihost.ShardMesh``); every candidate successor is owned by the
shard ``fp_lo mod D``:

- each shard expands its chunk of the frontier with the per-chunk stages
  of the single-device engine (``engine/pipeline.py``: the action kernels
  on every cell, the enabled cells squeezed in candidate order,
  fingerprints by kernel K1);
- the candidates go to their owners: "all_to_all" routes each source
  shard's candidates into D per-owner buckets and sends each bucket to its
  owner; "all_gather" sends every candidate to every shard, which keeps
  the ones it owns.  The raw payload is one int32 tensor a chunk, [W, 2 +
  K + 2] rows (hi, lo, the K lanes, the level-global parent, the action);
  the compressed one (below) packs the fingerprint lanes;
- each owner sees its candidates source shard by source shard, each in
  candidate order, sorts them stably by fingerprint (the first copy
  wins) and dedups them against its own visited set: the sorted set of
  order keys ("device"), a K2 hash table ("device-hash", one a shard,
  launched once a local shard a chunk) or a native host set ("host", on
  the process that owns the shard; the novelty masks are OR-merged across
  processes).  Its new states, in fingerprint order, are its shard of the
  next frontier.

The result is the JAX package's at the same D, with zero tolerance: the
levels, the per-shard new counts, the first violation (lowest invariant,
then lowest shard, then its first row in the chunk; a deadlock: the
lowest shard) and its trace value for value, the level digest chain
(which is the single-device chain: it digests the level multisets) and
the exchange framing verdict.  The chunk plan is copied exactly, since it
decides which duplicate wins: each level splits every shard's pending
rows in buckets of ``min(next_pow2(max(rem, min_bucket // D, 32)),
chunk)`` rows, and the bucket selects the candidate order
(``pipeline.compacts``, with this engine's gate of 1024).

Widths.  XLA compiles fixed shapes, so the JAX step sizes its per-owner
buckets (``_default_dest_w`` and a doubling ladder on overflow), its
compact widths (``AdaptiveCompact``) and its sorted sets' capacity
(``max vn + receive width``) by policy and re-runs a chunk that
overflows.  Here every width is an exact count: W is the largest
(source, owner) bucket of the chunk, and the sorted sets grow to the next
power of two over the largest ``vn + new``.  So ``dest_w`` and
``visited_capacity_per_shard`` differ from the JAX package's (ROADMAP
"Not followed"); no array of a checkpoint that depends only on the search
does.

Processes.  The host loop is replicated (``multihost``): every process
holds every shard's pending rows and takes the same decisions; it expands
and dedups its own shards, and an all-gather brings every shard's chunk
outcome to every process.  Within one process the exchange is a
transpose; with a process group (gloo on the CPU, NCCL on the card) every
exchange and gather is a collective, even at world size 1.

Checkpoints are the JAX package's files, array for array
(``sharded_checkpoint.npz``, the per-host ``.host<p>`` parts of a
multi-process host run, the mesh stamps ``mesh_D``/``mesh_P`` and the
legacy ident alias), so either package resumes the other's, on the same
mesh or elastically on another (``_elastic_reshard``).  With a trace
asked for, a checkpointed run writes per-shard parent logs under
``<checkpoint_dir>/plog`` (``storage/parent_log.py::ShardedParentLog``).

The overlap layer (``overlap``, ``$KSPEC_OVERLAP``, on by default, as in
the JAX package; off is the serial path, the bit-identity oracle):

- the compressed ``all_to_all`` (``ops/fpcompress.py``): on with the
  layer where the shards sit on a CUDA device (the JAX package's "not the
  CPU backend"), with fewer than 255 actions; ``KSPEC_EXCHANGE_COMPRESS=
  1``/``0`` forces it either way.  Each owner bucket is sorted stably by
  fingerprint (sentinels last), its fingerprint lanes bit-packed and
  delta-encoded, its rows and parents sent at the compact width ``Wr``,
  its action ids as u8; the receiver decodes them into the raw layout, so
  the received framing digest is taken over the decoded lanes.  Widths:
  the raw wire is exactly W rows (the largest bucket); the compressed one
  is ``max(32, 2 W)`` rows wide (``Wr`` is then at least W), doubling
  while a stream overflows its ``default_stream_words`` budget, and a
  chunk whose stream still overflows at full width (a bucket as wide as
  a whole source's candidates) goes raw: the JAX package's ladder and its
  fallback.  ``exchange_raw_bytes`` are the bytes the raw wire sends for
  the same chunks (at its exact width W), so ``exchange_raw_bytes /
  exchange_bytes`` is what the codec saves.  The stream's budget at the
  compressed width is ``2 W`` words, 64 bits a row of the widest bucket:
  the raw fingerprint lanes' own size.  So at these widths the codec
  saves no fingerprint bytes, and the saving is the u8 action ids' (3
  bytes a row) less the headers (ROADMAP "Not followed");
- the staged host commit (``visited_backend="host"``): chunk k+1 is
  dispatched before chunk k's commit; commits run in dispatch order, so
  at most two chunks are staged (``staged_chunks_peak``);
- checkpoint writes on the ``kspec-ckpt`` thread (each process writes its
  own ``.host<p>`` part), and the disk tier's merges on ``kspec-io``.

The disk tier (``store="disk"``, or ``mem_budget`` with ``store="auto"``)
turns the host backend's per-shard sets into ``TieredFpSet``s under
``<spill_dir or checkpoint_dir/spill or a temporary directory>/shard<d>``,
each with ``budget // (shards this process owns)`` bytes; checkpoints
record each shard's run manifest and hot dump.  The resource governor
(``disk_budget``, ``$KSPEC_DISK_BUDGET``/``RSS_BUDGET``/``LEVEL_DEADLINE``,
``stall@level``) watches the spill and checkpoint directories: a soft
breach reclaims, a hard one checkpoints and raises ``ResourceExhausted``
(CLI exit 75).

The device-resident sharded level (``pipeline="device"``,
``$KSPEC_PIPELINE=device``; ``ShardedDeviceLevel``): each level's
full-size gated chunks are queued on every local shard with no host read
between them, the exchange at the JAX package's fixed widths (its
overflow flags kept on the card), and the host reads the level once (twice
when an overflow re-dispatches it at the exact widths).  On the
``device`` backend each shard's visited set takes one merge a level and
the chain folds the digests accumulated on the card; on ``host`` and the
disk tier each owner's set takes the level's winners in one batched
insert.  The smaller-bucket tail of a level runs per chunk at its serial
offsets; ``device-hash``, unproven field hulls and a failed level degrade
stickily to the per-chunk path (``stats["device"]``).  The result is the
per-chunk path's; each level that the device level serves counts 1
launch (2 after an overflow) in ``kspec_shard_launches_level``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..analysis import require_encoding_sound
from ..engine.bfs import CheckResult, Violation, resolve_device, walk_trace
from ..engine.pipeline import (PooledWidths, chunk_novelty, compact_stage, compacts,
                               deadlock_rows, device_hull_fallback, expand_stage, first_copies,
                               fp_masked, fp_stage, next_pow2, sorted_emit, squeeze_stage)
from ..interop import from_u32, to_u32
from ..obs import metrics as _met
from ..obs.observer import RunObserver
from ..ops import dedup, devlevel, fpcompress, hashset
from ..ops.cuda_hashset import probe_insert
from ..overlap import AsyncWorker, close_workers, overlap_enabled, worker_counters
from ..pipeline_registry import resolve_pipeline
from ..resilience import integrity as _integ
from ..resilience.checkpoints import CheckpointStore
from ..resilience.faults import WIRED_SHARDED, FaultPlan
from ..resilience.heartbeat import append_jsonl, heartbeat_record
from ..resilience.integrity import IntegrityError
from ..resilience.resources import ResourceExhausted, ResourceGovernor, is_disk_full
from ..resilience.retry import ChunkRetryHandler
from ..storage import DEFAULT_MEM_BUDGET, TieredFpSet, parse_mem_budget, resolve_store
from ..storage.atomic import sweep_tmp
from ..storage.parent_log import ParentLogCorrupt, ShardedParentLog
from ..storage.runs import RunCorrupt, SortedRun
from .multihost import (ShardMesh, all_gather_shards, all_to_all_shards, fetch_global,
                        gather_rows, is_coordinator, is_multiprocess, max_across_processes,
                        mesh_layouts, or_across_processes, process_count, stack_global)

# per-shard hash-table floor (module-level so tests can shrink it to
# exercise growth at small state counts)
_HASH_MIN_CAP = 1 << 14
# what the JAX package saves as `vcap` and reports as the per-shard
# capacity on the host backend: its placeholder arrays' width
_NO_SORTED_CAP = 64
CHECKPOINT_BASENAME = "sharded_checkpoint.npz"
COMPRESS_ENV = "KSPEC_EXCHANGE_COMPRESS"
_U32 = 0xFFFFFFFF
# the u8 wire of an action id: a sentinel row's -1 rides as 255
_NO_ACT = 255


def _shard_tables_from_pairs(per_shard: dict, min_cap: int, device_of):
    """Uniform-capacity per-shard K2 tables from per-shard (hi, lo) pairs.

    `per_shard`: local shard -> (hi, lo) int64 tensors.  Every shard of
    every process shares one capacity, ``next_pow2(max(min_cap, 4 * the
    largest shard's count))``; if any table's build grows past it (probe
    overflow, improbable at 1/4 load), every table is rebuilt at the
    larger capacity.  -> (tables, cap)."""
    n_max = max_across_processes(max((int(h.shape[0]) for h, _ in per_shard.values()),
                                     default=1))
    cap = next_pow2(max(min_cap, 4 * max(n_max, 1)))
    while True:
        tables, grown = {}, cap
        for d, (hi, lo) in per_shard.items():
            t = hashset.table_from_pairs(hi.to(device_of(d)), lo.to(device_of(d)), min_cap=cap)
            tables[d] = t
            grown = max(grown, int(t.shape[0]))
        grown = max_across_processes(grown)
        if grown == cap:
            return tables, cap
        cap = grown


def _grow_hash_tables(tables: dict, new_cap: int, device_of):
    """Rehash every shard's table into (>=) `new_cap` slots, all shards
    together (the JAX rule: one capacity).  -> (tables, cap)."""
    pairs = {d: hashset.live_pairs(t) for d, t in tables.items()}
    return _shard_tables_from_pairs(pairs, new_cap, device_of)


def _grow_sorted_shards(keys: dict, new_cap: int) -> dict:
    """Every local shard's sorted set of order keys padded to `new_cap`."""
    return {d: torch.cat([k, torch.full((new_cap - k.shape[0],), dedup.PAD, dtype=torch.int64,
                                        device=k.device)]) for d, k in keys.items()}


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of a 1-D int64 tensor's entries (a tree of pairwise XORs)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return x.sum() if x.shape[0] else x.new_zeros(())


# kspec: traced
def _fp_digest(hi: torch.Tensor, lo: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exchange framing record: order-invariant (count, xor_hi, xor_lo,
    sum_hi, sum_lo) of a masked fingerprint multiset, the sums wrapping at
    32 bits as the JAX package's u32 lanes do: int64[5].  Taken per shard
    before and after the exchange; the host compares the global combines,
    so a bit flipped in a routed fingerprint desyncs the two."""
    mh = torch.where(mask, hi, 0)
    ml = torch.where(mask, lo, 0)
    return torch.stack([mask.sum(), _xor_reduce(mh), _xor_reduce(ml),
                        mh.sum() & _U32, ml.sum() & _U32])


def _combine_digs(dig: np.ndarray) -> tuple:
    """Host-side global combine of per-shard [D, 5] framing digests
    (counts sum exactly, xors xor, wrapping-u32 sums wrap)."""
    dig = np.asarray(dig, np.int64)
    return (
        int(dig[:, 0].sum()),
        int(np.bitwise_xor.reduce(dig[:, 1])) if dig.shape[0] else 0,
        int(np.bitwise_xor.reduce(dig[:, 2])) if dig.shape[0] else 0,
        int(dig[:, 3].sum() & _U32),
        int(dig[:, 4].sum() & _U32),
    )


def _sentinel_rows(n: int, F: int, device) -> torch.Tensor:
    """n empty payload rows: the sentinel fingerprint pair, zero lanes,
    parent and action -1."""
    rows = torch.zeros((n, F), dtype=torch.int32, device=device)
    rows[:, :2] = -1  # 0xFFFFFFFF as int32
    rows[:, F - 2:] = -1
    return rows


def _raw_bytes(D: int, W: int, K: int) -> int:
    """Bytes of one raw all_to_all at width W: D x D buckets of W rows of
    (hi, lo, K lanes, parent, action), 4 bytes each."""
    return D * D * (fpcompress.raw_bytes(W) + W * 4 * (K + 2))


def _default_dest_w(T: int, D: int) -> int:
    """The device level's per-owner bucket width for T candidate rows a
    source shard (the JAX package's rule)."""
    return max(64, T // D)


# kspec: traced
def _acc_digest(acc: torch.Tensor, dig: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """Fold one chunk's framing digest `dig` (int64[5], ``_fp_digest``)
    into a level accumulator by the host's combine rule (counts and
    wrapping sums add, xors xor), where `enabled` (a bool[] that masks the
    chunks the per-chunk path would not have compared)."""
    d = torch.where(enabled, dig, 0)
    return torch.stack([acc[0] + d[0], acc[1] ^ d[1], acc[2] ^ d[2], (acc[3] + d[3]) & _U32,
                        (acc[4] + d[4]) & _U32])


# kspec: traced
def _owner_counts(owner: torch.Tensor, D: int) -> torch.Tensor:
    """Rows a source shard sends each owner, int64[D + 1]: the last entry
    counts the rows of no owner (``owner == D``, the invalid rows of a
    fixed-width chunk)."""
    return torch.zeros(D + 1, dtype=torch.int64, device=owner.device).scatter_add_(
        0, owner, torch.ones_like(owner))


# kspec: traced
def _bucket_order(payload: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """A source shard's candidates grouped by owner, each owner's bucket
    ascending by fingerprint with ties in candidate order: the stable sort
    by order key, then the stable sort by owner."""
    key = dedup.order_key(payload[:, 0].to(torch.int64) & _U32,
                          payload[:, 1].to(torch.int64) & _U32)
    by_key = torch.sort(key, stable=True).indices
    return by_key[torch.sort(owner[by_key], stable=True).indices]


# kspec: traced
def _bucket_slots(oo: torch.Tensor, counts: torch.Tensor, W: int, D: int) -> torch.Tensor:
    """Each row's slot in the [D, W] bucket layout, for rows grouped by
    owner (`oo`, ascending) with `counts` from ``_owner_counts``: owner *
    W + its rank in the bucket, or the dump slot D * W for a row of no
    owner or past its bucket's W."""
    rank = torch.arange(oo.shape[0], device=oo.device) - (torch.cumsum(counts, 0) - counts)[oo]
    return torch.where((oo < D) & (rank < W), oo * W + rank, D * W)


# kspec: traced
def _raw_frames(p: torch.Tensor, owner: torch.Tensor, counts: torch.Tensor, W: int,
                D: int) -> torch.Tensor:
    """The raw wire of one source shard: its payload rows in D buckets of
    W rows, each in candidate order, padded with sentinel rows:
    int32[D, W, F]."""
    F = p.shape[1]
    buf = _sentinel_rows(D * W + 1, F, p.device)
    order = torch.sort(owner, stable=True).indices
    buf.index_copy_(0, _bucket_slots(owner[order], counts, W, D), p[order])
    return buf[: D * W].view(D, W, F)


# kspec: traced
def _packed_frames(p: torch.Tensor, owner: torch.Tensor, counts: torch.Tensor, W: int, Wr: int,
                   NW: int, D: int):
    """The compressed wire of one source shard: each of its D buckets at
    width W sorted by fingerprint (``_bucket_order``), its fingerprint
    lanes packed into NW stream words, the lanes and parent of its first
    Wr rows, its action ids as u8.  -> (int32[D, NW + header + Wr * (K +
    1)] (words, header, rows), uint8[D, Wr], bool[D] stream overflow)."""
    dev = p.device
    F = p.shape[1]
    K = F - 4
    order = _bucket_order(p, owner)
    oo, ps = owner[order], p[order]
    slot = _bucket_slots(oo, counts, W, D)
    slot_r = _bucket_slots(oo, counts, Wr, D)
    b_hi = torch.full((D * W + 1,), _U32, dtype=torch.int64, device=dev)
    b_lo = torch.full((D * W + 1,), _U32, dtype=torch.int64, device=dev)
    b_hi.index_copy_(0, slot, ps[:, 0].to(torch.int64) & _U32)
    b_lo.index_copy_(0, slot, ps[:, 1].to(torch.int64) & _U32)
    rows = torch.zeros((D * Wr + 1, K + 1), dtype=torch.int32, device=dev)
    rows[:, K] = -1
    rows.index_copy_(0, slot_r, ps[:, 2 : 2 + K + 1])
    act = torch.full((D * Wr + 1,), _NO_ACT, dtype=torch.uint8, device=dev)
    act.index_copy_(0, slot_r, ps[:, F - 1].to(torch.uint8))
    words, header, over = fpcompress.pack_sorted(b_hi[: D * W].view(D, W),
                                                 b_lo[: D * W].view(D, W), counts[:D], NW)
    frame = torch.cat([words.to(torch.int32), header.to(torch.int32),
                       rows[: D * Wr].view(D, Wr * (K + 1))], dim=1)
    return frame, act[: D * Wr].view(D, Wr), over


# kspec: traced
def _unpacked_rows(f: torch.Tensor, a: torch.Tensor, W: int, Wr: int, NW: int,
                   K: int) -> torch.Tensor:
    """What an owner received on the compressed wire, decoded into the raw
    layout: int32[D * W, F], source by source, each bucket's rows in
    fingerprint order, then sentinel rows."""
    D = f.shape[0]
    F = K + 4
    HW = fpcompress.header_words(W)
    f = f.to(torch.int64)
    hi, lo = fpcompress.unpack_sorted(f[:, :NW] & _U32, f[:, NW : NW + HW] & _U32, W)
    r = _sentinel_rows(D * W, F, f.device).view(D, W, F)
    r[:, :, 0] = hi.to(torch.int32)
    r[:, :, 1] = lo.to(torch.int32)
    r[:, :Wr, 2 : 2 + K + 1] = f[:, NW + HW :].view(D, Wr, K + 1).to(torch.int32)
    a = a.to(torch.int32)
    r[:, :Wr, F - 1] = torch.where(a == _NO_ACT, -1, a)
    return r.reshape(D * W, F)


# kspec: traced
def _padded_rows(p: torch.Tensor, T: int) -> torch.Tensor:
    """A source shard's payload padded with sentinel rows to T rows (the
    all_gather wire)."""
    buf = _sentinel_rows(T, p.shape[1], p.device)
    buf[: p.shape[0]] = p
    return buf


def _gathered(allc: torch.Tensor, mesh: ShardMesh) -> dict:
    """The all_gather wire's receive: every source's rows on every local
    owner, with `mine` masking the candidates it owns."""
    D = mesh.size
    owner = (allc[:, 1].to(torch.int64) & _U32) % D
    return {d: (allc.to(mesh.device(d)), (owner == d).to(mesh.device(d))) for d in mesh.my_shards}


def _compressed_bytes(D: int, W: int, Wr: int, NW: int, K: int) -> int:
    """Bytes of one compressed all_to_all: each bucket's stream and header,
    then Wr rows of K lanes and the parent (4 bytes each) and the u8
    action id."""
    return D * D * (fpcompress.packed_bytes(W, NW) + Wr * (4 * (K + 1) + 1))


def _make_exchange(mesh: ShardMesh, exchange: str, K: int):
    """The per-chunk candidate exchange.  -> route(payloads, owners,
    compress) with `payloads`: local source shard -> int32[n, 2 + K + 2]
    candidate rows in candidate order, `owners`: their owner shards; it
    returns, per local owner shard, (int32[R, 2 + K + 2], mine): what every
    source shard sent it, source by source, padded with sentinel rows, and
    `mine` None (all_to_all), or every candidate with `mine` masking the
    owner's (all_gather); and the wire record {"compressed": the chunk
    went compressed, "sent": bytes on the all_to_all wire, "raw": the raw
    wire's bytes for the same chunk, at its exact width}.  Raw, each source's rows keep candidate
    order; compressed, each bucket is in fingerprint order with ties in
    candidate order, which elects the same first copies.  The widths are
    exact, read from the chunk's bucket counts; the frames are the device
    level's (``_level_route``), which sends at fixed widths."""
    if exchange not in ("all_to_all", "all_gather"):
        raise ValueError(f"unknown exchange {exchange!r}")
    D = mesh.size

    def route_compressed(payloads, owners, counts, cmax):
        """The compressed wire, or None when a stream overflows at full
        width (the chunk then goes raw)."""
        W = max(32, 2 * cmax)
        # full width: one bucket as wide as a whole source's candidates
        T = max(W, max_across_processes(max(p.shape[0] for p in payloads.values())))
        while True:
            Wr = max(32, W // 2)
            NW = fpcompress.default_stream_words(W)
            frames = {d: _packed_frames(payloads[d], owners[d], counts[d], W, Wr, NW, D)
                      for d in mesh.my_shards}
            ovf = any(bool(f[2].any()) for f in frames.values())
            if not or_across_processes(np.array([ovf]))[0]:
                break
            if W >= T:
                return None
            W = min(T, 2 * W)
        got = all_to_all_shards([frames[d][0] for d in mesh.my_shards], mesh)
        got_act = all_to_all_shards([frames[d][1] for d in mesh.my_shards], mesh)
        recv = {d: (_unpacked_rows(f, a, W, Wr, NW, K), None)
                for d, f, a in zip(mesh.my_shards, got, got_act)}
        return recv, {"compressed": True, "sent": _compressed_bytes(D, W, Wr, NW, K),
                      "raw": _raw_bytes(D, cmax, K)}

    def route_a2a(payloads: dict, owners: dict, compress: bool):
        counts = {d: _owner_counts(owners[d], D) for d in mesh.my_shards}
        local_max = max((int(c.max()) for c in counts.values()), default=0)
        cmax = max(1, max_across_processes(local_max))
        if compress:
            got = route_compressed(payloads, owners, counts, cmax)
            if got is not None:
                return got
        W = cmax
        recv = all_to_all_shards([_raw_frames(payloads[d], owners[d], counts[d], W, D)
                                  for d in mesh.my_shards], mesh)
        raw = _raw_bytes(D, W, K)
        return ({d: (r.reshape(D * W, -1), None) for d, r in zip(mesh.my_shards, recv)},
                {"compressed": False, "sent": raw, "raw": raw})

    def route_gather(payloads: dict, owners: dict, compress: bool):
        local_max = max((p.shape[0] for p in payloads.values()), default=0)
        T = max(1, max_across_processes(local_max))
        allc = all_gather_shards([_padded_rows(payloads[d], T) for d in mesh.my_shards], mesh)
        return _gathered(allc.reshape(D * T, -1), mesh), {"compressed": False, "sent": 0, "raw": 0}

    return route_a2a if exchange == "all_to_all" else route_gather


# kspec: traced
def _level_route(mesh: ShardMesh, exchange: str, compress: bool, payloads: dict, owners: dict,
                 W: int, T: int, K: int):
    """The device level's exchange at fixed widths, which reads nothing:
    the per-chunk route's frames at W rows a bucket (all_to_all; the
    compressed wire ``Wr = max(32, W // 2)`` rows and
    ``default_stream_words(W)`` words) or T rows a source (all_gather).
    `payloads`: local source shard -> int32[T, F], `owners`: each row's
    owner, D for an invalid row.  -> ({local owner: (int32[R, F], mine)},
    {local source: bool[] overflow}): a bucket wider than W (raw), and also
    wider than Wr or past its stream (compressed)."""
    D = mesh.size
    if exchange == "all_gather":
        allc = all_gather_shards([payloads[d] for d in mesh.my_shards], mesh)
        return _gathered(allc.reshape(D * T, -1), mesh), {
            d: torch.zeros((), dtype=torch.bool, device=payloads[d].device)
            for d in mesh.my_shards}
    counts = {d: _owner_counts(owners[d], D) for d in mesh.my_shards}
    ovf = {d: (c[:D] > W).any() for d, c in counts.items()}
    if not compress:
        recv = all_to_all_shards([_raw_frames(payloads[d], owners[d], counts[d], W, D)
                                  for d in mesh.my_shards], mesh)
        return {d: (r.reshape(D * W, -1), None) for d, r in zip(mesh.my_shards, recv)}, ovf
    Wr = max(32, W // 2)
    NW = fpcompress.default_stream_words(W)
    frames = {d: _packed_frames(payloads[d], owners[d], counts[d], W, Wr, NW, D)
              for d in mesh.my_shards}
    for d, (_f, _a, over) in frames.items():
        ovf[d] = ovf[d] | (over | (counts[d][:D] > Wr)).any()
    got = all_to_all_shards([frames[d][0] for d in mesh.my_shards], mesh)
    got_act = all_to_all_shards([frames[d][1] for d in mesh.my_shards], mesh)
    return ({d: (_unpacked_rows(f, a, W, Wr, NW, K), None)
             for d, f, a in zip(mesh.my_shards, got, got_act)}, ovf)


def _make_sharded_step(model, mesh: ShardMesh, exchange: str, visited_backend: str,
                       compact_shift: int, compact_gate: int, check_deadlock: bool):
    """One chunk over every local shard: expansion, the exchange and each
    owner's dedup.  -> step(frontier, base, bucket, vis, compress) where
    `frontier`: local shard -> int64[rows, K] (this chunk's rows of its
    pending), `base`: local shard -> the level-global index of its first
    row, `compress`: send the all_to_all compressed.  Returns (flags, outs,
    wire): `flags`, local shard -> int64 vector [inv_any (I),
    inv_row (I), deadlock, deadlock_row, enabled per action (A), sent
    digest (5), received digest (5)]; `outs`, local owner shard -> int64[n,
    K + 4] (the lanes, parent, action, hi, lo) of its winners in
    fingerprint order: the new states on the device backends, the first
    copies on the host backend (the host set judges them at the commit);
    `wire`, the exchange's record (``_make_exchange``)."""
    spec = model.spec
    K = spec.num_lanes
    D = mesh.size
    A = len(model.actions)
    n_inv = len(model.invariants)
    route = _make_exchange(mesh, exchange, K)

    def expand(rows: torch.Tensor, base: int, action_major: bool):
        """A source shard's chunk -> (flags head, payload int32[n, F], owners)."""
        dev = rows.device
        if rows.shape[0] == 0:
            head = torch.zeros(2 * n_inv + 2 + A, dtype=torch.int64, device=dev)
            return head, torch.zeros((0, 4 + K), dtype=torch.int32, device=dev), \
                torch.zeros(0, dtype=torch.int64, device=dev), (rows.new_zeros(0),) * 2
        states = spec.unpack(rows)
        if n_inv:
            bad = torch.stack([~inv.pred(states) for inv in model.invariants])
            inv_any = bad.any(dim=1).to(torch.int64)
            inv_row = torch.argmax(bad.to(torch.uint8), dim=1)
        else:
            inv_any = inv_row = rows.new_zeros(0)
        en_pre, parts = expand_stage(model, states)
        if check_deadlock:
            dead = deadlock_rows(en_pre)
            dl = torch.stack([dead.any().to(torch.int64), torch.argmax(dead.to(torch.uint8))])
        else:
            dl = rows.new_zeros(2)
        act_en = torch.stack([e.sum() for e, _ in parts])
        crows, cparent, cact = squeeze_stage(spec, parts, action_major)
        hi, lo = fp_stage(spec, crows)  # K1 on the card
        payload = torch.cat([hi[:, None], lo[:, None], crows, (cparent + base)[:, None],
                             cact[:, None]], dim=1).to(torch.int32)
        return torch.cat([inv_any, inv_row, dl, act_en]), payload, lo % D, (hi, lo)

    def step(frontier: dict, base: dict, bucket: int, vis, compress: bool) -> tuple:
        action_major = compacts(bucket, compact_shift, compact_gate)
        heads, payloads, owners, sent = {}, {}, {}, {}
        for d in mesh.my_shards:
            head, payloads[d], owners[d], (hi, lo) = expand(frontier[d], base[d], action_major)
            heads[d] = head
            sent[d] = _fp_digest(hi, lo, torch.ones_like(hi, dtype=torch.bool))
        recv, wire = route(payloads, owners, compress)
        # each owner: first copies in fingerprint order, then its visited set
        firsts = {}
        for d in mesh.my_shards:
            r, mine = recv[d]
            hi = r[:, 0].to(torch.int64) & _U32
            lo = r[:, 1].to(torch.int64) & _U32
            valid = ~((hi == dedup.SENT) & (lo == dedup.SENT))
            if mine is not None:
                # all_gather: the candidates this shard does not own turn
                # into sentinels, which sort last and are never new
                valid &= mine
                hi = torch.where(valid, hi, dedup.SENT)
                lo = torch.where(valid, lo, dedup.SENT)
            heads[d] = torch.cat([heads[d], sent[d], _fp_digest(hi, lo, valid)])
            sk, order, first = first_copies(dedup.order_key(hi, lo))
            firsts[d] = (r, hi, lo, sk, order, first & (sk != dedup.PAD))
        winners = vis.novelty(firsts)
        outs = {}
        for d in mesh.my_shards:
            r, hi, lo, _sk, order, _first = firsts[d]
            idx = order[winners[d].nonzero().squeeze(1)]
            w = r[idx]
            lanes = w[:, 2 : 2 + K].to(torch.int64) & _U32
            outs[d] = torch.cat([lanes, w[:, 2 + K :].to(torch.int64), hi[idx, None],
                                 lo[idx, None]], dim=1)
        return heads, outs, wire

    return step


class _ShardSets:
    """The visited sets of this process's shards, one backend's kind.

    ``device``: each shard's sorted order keys (``ops/dedup.py``), all
    padded to one capacity ``cap``; ``device-hash``: one K2 table a shard,
    one capacity, grown for all together (``_grow_hash_tables``);
    ``host``: one native set a shard, on its owner process only."""

    def __init__(self, backend: str, mesh: ShardMesh):
        self.backend = backend
        self.mesh = mesh
        self.keys: dict = {}  # device: order keys; device-hash: the table
        self.vn: dict = {}  # device: each local shard's set size
        self.host: list = [None] * mesh.size  # host: FpSet per owned shard
        self.cap = _NO_SORTED_CAP

    def dev(self, d: int):
        return self.mesh.device(d)

    # --- building ------------------------------------------------------
    def build(self, pairs: dict, lens, cap: Optional[int] = None) -> None:
        """From every local shard's (hi, lo) pairs (the sorted backend:
        ascending), `lens` every shard's count; `cap`: the sorted sets'
        capacity (None: the JAX package's initial rule)."""
        if self.backend == "host":
            from ..native import FpSet

            for d, (hi, lo) in pairs.items():
                s = FpSet(initial_capacity=max(64, 2 * int(hi.shape[0])))
                if hi.shape[0]:
                    s.insert(dedup.pair_key(hi, lo).cpu().numpy().view(np.uint64))
                self.host[d] = s
        elif self.backend == "device-hash":
            self.keys, self.cap = _shard_tables_from_pairs(pairs, _HASH_MIN_CAP, self.dev)
        else:
            self.cap = cap
            for d, (hi, lo) in pairs.items():
                k = dedup.order_key(hi, lo).to(self.dev(d))
                self.keys[d] = torch.cat([k, torch.full((cap - k.shape[0],), dedup.PAD,
                                                        dtype=torch.int64, device=k.device)])
                self.vn[d] = int(hi.shape[0])

    def reserve(self, shard_visited: np.ndarray) -> None:
        """device-hash, before a chunk: keep every table under 1/2 load."""
        if self.backend == "device-hash" and 2 * int(shard_visited.max()) > self.cap:
            self.keys, self.cap = _grow_hash_tables(self.keys, 2 * self.cap, self.dev)

    # --- the chunk's dedup ---------------------------------------------
    def novelty(self, firsts: dict) -> dict:
        """Per local owner: bool over its sorted candidates, True for the
        new ones (host: the first copies; the host set judges at commit)."""
        if self.backend == "host":
            return {d: f[5] for d, f in firsts.items()}
        if self.backend == "device":
            found = {}
            for d, (_r, _hi, _lo, sk, _order, first) in firsts.items():
                seen, rank = dedup.rank_sorted(self.keys[d], self.vn[d], sk)
                is_new = first & ~seen
                found[d] = (is_new, rank, int(is_new.sum()))
            need = max_across_processes(max((self.vn[d] + n for d, (_, _, n) in found.items()),
                                            default=0))
            if need > self.cap:
                self.cap = next_pow2(need)
                self.keys = _grow_sorted_shards(self.keys, self.cap)
            out = {}
            for d, (is_new, rank, _n) in found.items():
                sel = is_new.nonzero().squeeze(1)
                sk = firsts[d][3]
                self.keys[d], self.vn[d] = dedup.merge_ranked(self.keys[d], self.vn[d], sk[sel],
                                                              rank[sel], self.cap)
                out[d] = is_new
            return out
        # device-hash: insert-or-find of the first copies, in key order (K2
        # takes the first copies alone, not the padded receive width)
        out = {d: torch.zeros_like(f[5]) for d, f in firsts.items()}
        pend = dict(firsts)
        while True:
            ovf = np.zeros(self.mesh.size, bool)
            for d, (_r, hi, lo, _sk, order, first) in pend.items():
                sel = first.nonzero().squeeze(1)
                if not sel.shape[0]:
                    continue
                q = dedup.pair_key(hi[order[sel]], lo[order[sel]])
                self.keys[d], is_new, _n, o = probe_insert(self.keys[d], q)
                out[d][sel] |= is_new
                ovf[d] = o
            ovf = or_across_processes(ovf)
            if not ovf.any():
                return out
            # a shard ran out of probes: every table grows, and the
            # overflowing shards insert again (rows the failed attempt
            # inserted report seen now; OR-ing keeps them new)
            self.keys, self.cap = _grow_hash_tables(self.keys, 2 * self.cap, self.dev)
            pend = {d: f for d, f in pend.items() if ovf[d]}

    # --- checkpoint dumps ----------------------------------------------
    def dump_pairs(self) -> list:
        """Every shard's visited (hi, lo) u32 arrays, all processes' shards
        gathered (device: ascending; device-hash: slot order)."""
        local = []
        for d in self.mesh.my_shards:
            if self.backend == "device":
                hi, lo = dedup.order_key_to_pair(self.keys[d][: self.vn[d]])
            else:
                hi, lo = hashset.live_pairs(self.keys[d])
            local.append(torch.stack([hi, lo], dim=1))
        got = gather_rows(local, 2)
        return [(to_u32(g[:, 0]), to_u32(g[:, 1])) for g in got]


class _ShardAcc:
    """One local shard's part of a queued device level: its frontier
    buffer and what its chunks fold into, on the shard's device."""

    def __init__(self, fbuf, flen: int, base: int, st: "_ShardLevel", actions, host_mode: bool):
        dev = fbuf.device
        K = fbuf.shape[1]
        A = len(actions)
        LN = st.LN
        self.fbuf, self.flen, self.base = fbuf, flen, base
        self.ar_B = torch.arange(st.B, device=dev)
        self.ar_lat = [torch.arange(st.B * a.n_choices, device=dev) for a in actions]
        self.ar_W = [torch.arange(w, device=dev) for w in st.widths]
        self.act_ids = torch.cat([torch.full((w,), i, dtype=torch.int64, device=dev)
                                  for i, w in enumerate(st.widths)])
        # the winners: LN rows and a dump row
        self.orows = torch.zeros((LN + 1, K), dtype=torch.int64, device=dev)
        self.opar = torch.zeros(LN + 1, dtype=torch.int64, device=dev)
        self.oact = torch.zeros(LN + 1, dtype=torch.int64, device=dev)
        self.okeys = torch.zeros(LN + 1, dtype=torch.int64, device=dev) if host_mode else None
        self.lkeys = torch.full((LN,), dedup.PAD, dtype=torch.int64, device=dev)
        self.on = torch.zeros((), dtype=torch.int64, device=dev)
        self.act_en = torch.zeros(A, dtype=torch.int64, device=dev)
        self.agmax = torch.zeros(A, dtype=torch.int64, device=dev)
        self.dig = devlevel.zero_digest(dev)
        self.sacc = torch.zeros(5, dtype=torch.int64, device=dev)
        self.racc = torch.zeros(5, dtype=torch.int64, device=dev)
        self.merged = None  # device mode: the visited keys after the level's one merge


class _ShardLevel:
    """One dispatch of a sharded device level: every local shard's
    ``_ShardAcc`` and the replicated verdict and overflow flags (on this
    process's first shard's device)."""

    def __init__(self, sdev: "ShardedDeviceLevel", pending: list, lens: list, prev_base,
                 B: int, nc: int, widths: tuple, LN: int, W: int, compress: bool, vkeys):
        mesh = sdev.mesh
        self.B, self.nc, self.widths, self.LN, self.W = B, nc, widths, LN, W
        self.T = sum(widths)
        self.compress, self.vkeys = compress, vkeys
        self.home = mesh.device(mesh.my_shards[0])
        self.shards = {}
        for d in mesh.my_shards:
            n = min(nc * B, lens[d])
            fbuf = pending[d][:n].to(mesh.device(d))
            if nc * B > n:
                fbuf = torch.cat([fbuf, fbuf.new_zeros((nc * B - n, fbuf.shape[1]))])
            self.shards[d] = _ShardAcc(fbuf, n, int(prev_base[d]), self, sdev.model.actions,
                                       sdev.host_mode)
        z = torch.zeros((), dtype=torch.int64, device=self.home)
        self.vkind, self.vshard, self.vinv, self.vidx, self.nclean = (z.clone() for _ in range(5))
        self.ovf = torch.zeros((), dtype=torch.bool, device=self.home)


class LevelRead(NamedTuple):
    """A sharded device level's one host read, over every shard: the
    replicated flags (overflow, verdict kind, shard, invariant and
    frontier row, clean chunks) and each shard's [D] / [D, n] outcome."""

    ovf: bool
    vkind: int
    vshard: int
    vinv: int
    vidx: int
    nclean: int
    on: np.ndarray
    act_en: np.ndarray
    agmax: np.ndarray
    sacc: np.ndarray
    racc: np.ndarray
    dig: np.ndarray
    keys: Optional[np.ndarray]


class ShardedDeviceLevel:
    """The sharded device-resident level (``pipeline="device"``): every
    full-size gated chunk of a level queued on every local shard with no
    host read between chunks, the host reading the level once (twice on
    an overflow re-dispatch).  Counterpart of the JAX package's
    ``ShardedDeviceLevel`` and its two level programs; the chunk's stages
    are the single-device ``DevicePipeline``'s (``compact_stage``,
    ``fp_masked``, ``chunk_novelty``, ``sorted_emit``, ``ops/devlevel``)
    with the exchange (``_level_route``) between expansion and novelty.

    A chunk, on each local shard: the frontier slice, the compacted
    expansion at the plan's widths, K1, the parent as a level-global
    index, the sent framing digest, the route, the received digest,
    novelty against the shard's level-new set (and, on the ``device``
    backend, the read-only visited shard), the merge of its winners into
    the level-new set, their appends in fingerprint order (the per-chunk
    path's emission order), the digest fold (``device``), and the framing
    accumulators, the enablement, the guard maxima and the clean-chunk
    count.  The verdict and the overflow flags are elected replicated
    (every shard's flags gathered: a reduction over the local shards, an
    all-gather on the group's device with one), with the serial priority:
    invariants beat deadlock, then the first invariant in declaration
    order, then the lowest shard, then its first row.  A Python loop
    cannot stop at the verdict without a read, so every chunk runs; the
    verdict chunk folds its guard maxima and framing digests and commits
    nothing, and the chunks after it fold nothing.  After the loop, on
    ``device``, one rank merge a shard into its visited set.  On ``host``
    (and the disk tier) the level's winners go to each owner's host set
    in one batched insert after the read.

    The policy is the JAX package's: the plan (``plan_level``), the widths
    (``PooledWidths``), the per-owner width ``_default_dest_w``, the
    level-new ladder, and one re-dispatch on an overflow at the measured
    maxima, W = T, the codec off and the safe level-new bound.  Any unmet
    precondition, or a failure of the level that the retry handler does
    not retry, degrades the run stickily to the per-chunk path
    (``mark_fallback``)."""

    def __init__(self, model, mesh: ShardMesh, visited_backend: str, check_deadlock: bool,
                 compact_shift: int, compact_gate: int, exchange: str):
        from ..pipeline_registry import backend_fallback_reason

        self.model = model
        self.mesh = mesh
        self.check_deadlock = check_deadlock
        self.compact_shift, self.compact_gate = compact_shift, compact_gate
        self.exchange = exchange
        self.pool = PooledWidths(model.actions)
        self.ln_hw = 0  # the run's per-level new-state high water (per shard)
        self.levels = 0  # levels run device-resident
        # deferred probe: the level carries no visited shards; the host
        # sets take each shard's level batch once
        self.host_mode = visited_backend == "host"
        self.fallback: Optional[str] = backend_fallback_reason("device", visited_backend)
        if self.fallback is None:
            self.fallback = device_hull_fallback(model)

    def _gated(self, B: int) -> bool:
        """The per-chunk path takes the compact (action-major) order at
        this bucket; below the gate its state-major order is the per-chunk
        path's alone."""
        return compacts(B, self.compact_shift, self.compact_gate)

    def plan_level(self, lens, chunk: int, min_bucket: int):
        """-> (B, chunks) when the level serves (a prefix of) this level's
        per-chunk plan, else None: the prefix of chunks whose per-chunk
        bucket is the level's uniform one; a smaller-bucket tail runs per
        chunk afterwards at its serial offsets."""
        if self.fallback is not None:
            return None
        D = self.mesh.size
        rem = max(lens) if lens else 0
        if rem <= 0:
            return None
        mb = max(min_bucket // D, 32)
        if rem <= chunk:
            B = min(next_pow2(max(rem, mb)), chunk)
            return (B, 1) if self._gated(B) else None
        if not self._gated(chunk):
            return None
        nfull, r = 0, rem
        while r > 0 and min(next_pow2(max(r, mb)), chunk) == chunk:
            nfull += 1
            r -= chunk
        return (chunk, nfull) if nfull else None

    def widths(self, B: int) -> tuple:
        return self.pool.widths_for(B, np.zeros(len(self.model.actions)))

    def exact_widths(self, B: int, agmax: np.ndarray) -> tuple:
        return self.pool.widths_for(B, agmax.astype(np.float64))

    def observe(self, agmax: np.ndarray, B: int, new_max: int) -> None:
        """Fold one level's measured maxima into the sizing ladders."""
        self.pool.hw = np.maximum(self.pool.hw, agmax.astype(np.float64) / max(B, 1))
        self.ln_hw = max(self.ln_hw, int(new_max))
        self.levels += 1

    def mark_fallback(self, reason: str, depth: int) -> None:
        self.fallback = reason
        from ..obs import tracer as _obs_t

        _obs_t.event("pipeline-fallback", depth=depth, pipeline="sharded-device", to="per-chunk",
                     error=reason[:200])

    # kspec: traced
    def queue_level(self, pending: list, lens: list, prev_base, B: int, nc: int, widths: tuple,
                    LN: int, W: int, compress: bool, vkeys, vn: dict) -> _ShardLevel:
        """Queue every chunk of one dispatch on every local shard, then (on
        ``device``) each shard's visited merge; reads nothing back."""
        st = _ShardLevel(self, pending, lens, prev_base, B, nc, widths, LN, W, compress, vkeys)
        for i in range(nc):
            self._chunk(st, i)
        if vkeys is not None:
            for d, s in st.shards.items():
                rank = dedup.rank_full(vkeys[d], s.lkeys)[1]
                s.merged = dedup.merge_full(vkeys[d], vn[d], s.lkeys, rank, s.on)
        return st

    # kspec: traced
    def _chunk(self, st: _ShardLevel, i: int) -> None:
        model, spec, mesh = self.model, self.model.spec, self.mesh
        D, B, K = mesh.size, st.B, spec.num_lanes
        start = i * B
        nI = max(len(model.invariants), 1)
        payloads, owners, src = {}, {}, {}
        for d, s in st.shards.items():
            fvalid = s.ar_B < min(B, s.flen - start)
            states = spec.unpack(s.fbuf[start : start + B])
            if model.invariants:
                bad = torch.stack([~inv.pred(states) for inv in model.invariants]) & fvalid
                v_any, v_idx = bad.any(dim=1), torch.argmax(bad.to(torch.uint8), dim=1)
            else:
                v_any = torch.zeros(1, dtype=torch.bool, device=fvalid.device)
                v_idx = torch.zeros(1, dtype=torch.int64, device=fvalid.device)
            en_pre, rows, valid, parent, guard, a_en, exp_ovf = compact_stage(
                model, states, fvalid, st.widths, s.ar_lat, s.ar_W)
            dead = deadlock_rows(en_pre, fvalid)
            hi, lo = fp_masked(spec, rows, valid)  # K1 on the card
            payloads[d] = torch.cat([hi[:, None], lo[:, None], rows,
                                     (parent + (s.base + start))[:, None], s.act_ids[:, None]],
                                    dim=1).to(torch.int32)
            owners[d] = torch.where(valid, lo % D, D)
            head = torch.cat([v_any.to(torch.int64), v_idx,
                              torch.stack([dead.any().to(torch.int64),
                                           torch.argmax(dead.to(torch.uint8))])])
            src[d] = (head, guard, a_en, exp_ovf, _fp_digest(hi, lo, valid))
        recv, ovf_dest = _level_route(mesh, self.exchange, st.compress, payloads, owners, st.W,
                                      st.T, K)
        novel, flags = {}, []
        for d, s in st.shards.items():
            r, mine = recv[d]
            hi = r[:, 0].to(torch.int64) & _U32
            lo = r[:, 1].to(torch.int64) & _U32
            valid = ~((hi == dedup.SENT) & (lo == dedup.SENT))
            if mine is not None:
                valid &= mine
                hi = torch.where(valid, hi, dedup.SENT)
                lo = torch.where(valid, lo, dedup.SENT)
            sk, order, is_new, rank_l = chunk_novelty(
                dedup.order_key(hi, lo), s.lkeys, None if st.vkeys is None else st.vkeys[d])
            new_n = is_new.sum()
            head, _g, _a, exp_ovf, _sd = src[d]
            flags.append(torch.cat([head, torch.stack([
                (exp_ovf | ovf_dest[d]).to(torch.int64),
                (s.on + new_n > st.LN).to(torch.int64)])]).to(st.home))
            novel[d] = (r, hi, lo, sk, order, is_new, rank_l, _fp_digest(hi, lo, valid))
        # the replicated election over every shard's flags
        g = stack_global(torch.stack(flags))
        g_viol = g[:, :nI] > 0
        g_vix = g[:, nI : 2 * nI]
        g_dl, g_dl_idx = g[:, 2 * nI] > 0, g[:, 2 * nI + 1]
        this_ovf = (g[:, 2 * nI + 2] > 0).any()
        ln_over = (g[:, 2 * nI + 3] > 0).any()
        inv_any = g_viol.any()
        inv_i = torch.argmax(g_viol.any(dim=0).to(torch.uint8))
        d_inv = torch.argmax(g_viol.index_select(1, inv_i.view(1))[:, 0].to(torch.uint8))
        dl_any = g_dl.any() & self.check_deadlock
        d_dl = torch.argmax(g_dl.to(torch.uint8))
        kind = torch.where(inv_any, 1, torch.where(dl_any, 2, 0))
        row = torch.where(inv_any, g_vix.reshape(-1).gather(0, (d_inv * nI + inv_i).view(1))[0],
                          g_dl_idx.gather(0, d_dl.view(1))[0]) + start
        live = st.vkind == 0
        take = live & (kind != 0)
        commit = live & (kind == 0)  # a verdict chunk commits nothing
        ln_ovf = commit & ln_over
        commit_ok = commit & ~st.ovf & ~ln_ovf
        # the framing folds every chunk the per-chunk path would compare:
        # a clean chunk, the verdict chunk included
        clean = live & ~st.ovf & ~this_ovf & ~ln_ovf
        st.ovf = st.ovf | (live & (this_ovf | ln_ovf))
        st.nclean = st.nclean + clean.to(torch.int64)
        st.vkind = torch.where(take, kind, st.vkind)
        st.vshard = torch.where(take, torch.where(inv_any, d_inv, d_dl), st.vshard)
        st.vinv = torch.where(take, inv_i, st.vinv)
        st.vidx = torch.where(take, row, st.vidx)
        for d, s in st.shards.items():
            dev = s.fbuf.device
            c_ok, cl, lv = commit_ok.to(dev), clean.to(dev), live.to(dev)
            r, hi, lo, sk, order, is_new, rank_l, rdig = novel[d]
            _h, guard, a_en, _e, sdig = src[d]
            app = is_new & c_ok
            app_n = app.sum()
            R = sk.shape[0]
            # the winners, sorted, merged into the level-new set
            pos = torch.where(app, torch.cumsum(app, 0) - 1, R)
            nk = torch.full((R + 1,), dedup.PAD, dtype=torch.int64, device=dev)
            nr = torch.zeros(R + 1, dtype=torch.int64, device=dev)
            nk.index_copy_(0, pos, sk)
            nr.index_copy_(0, pos, rank_l)
            s.lkeys = dedup.merge_full(s.lkeys, s.on, nk[:R], nr[:R], app_n)
            take_c, pos_c = sorted_emit(order, app)
            slots = devlevel.append_slots(pos_c, take_c, s.on, st.LN)
            devlevel.append_rows(s.orows, r[:, 2 : 2 + K].to(torch.int64) & _U32, slots)
            devlevel.append_vec(s.opar, r[:, 2 + K].to(torch.int64), slots)
            devlevel.append_vec(s.oact, r[:, 3 + K].to(torch.int64), slots)
            if s.okeys is not None:
                devlevel.append_vec(s.okeys, dedup.pair_key(hi, lo), slots)
            else:
                s.dig = devlevel.combine_digest(s.dig,
                                                devlevel.masked_digest(sk ^ dedup.TOP_BIT, app))
            s.on = s.on + app_n
            s.act_en = s.act_en + torch.where(c_ok, a_en, 0)
            s.agmax = torch.where(lv, torch.maximum(s.agmax, guard), s.agmax)
            s.sacc = _acc_digest(s.sacc, sdig, cl)
            s.racc = _acc_digest(s.racc, rdig, cl)

    def read_level(self, st: _ShardLevel) -> LevelRead:
        """The level's one host read, every shard's outcome on every
        process."""
        A = len(self.model.actions)
        local = []
        for d, s in st.shards.items():
            head = torch.stack([st.ovf.to(torch.int64), st.vkind, st.vshard, st.vinv, st.vidx,
                                st.nclean]).to(s.fbuf.device)
            parts = [head, s.on.view(1), s.act_en, s.agmax, s.sacc, s.racc, s.dig]
            if s.okeys is not None:
                parts.append(s.okeys[: st.LN])
            local.append(torch.cat(parts).to(st.home))
        g = fetch_global(torch.stack(local))
        o = 7
        cols = {}
        for name, n in (("act_en", A), ("agmax", A), ("sacc", 5), ("racc", 5), ("dig", 3)):
            cols[name] = g[:, o : o + n]
            o += n
        ovf, vkind, vshard, vinv, vidx, nclean = (int(v) for v in g[0, :6])
        return LevelRead(bool(ovf), vkind, vshard, vinv, vidx, nclean, g[:, 6].copy(),
                         keys=g[:, o:] if self.host_mode else None, **cols)


def _elastic_reshard(snap, part_arrays, old_D: int, old_P: int, old_pending, *, mesh, spec,
                     visited_backend: str, sets: _ShardSets, device, use_disk: bool = False,
                     spill_base: Optional[str] = None):
    """Re-bucket a checkpoint of another shard or process count onto this
    mesh (the JAX helper's rules).  Ownership is fingerprint arithmetic
    (owner = fp_lo mod D), so this is a deterministic re-dealing of every
    piece of persisted state, with no re-exploration:

    - pending rows are fingerprinted again and dealt to their new owners;
      within a shard the old concatenated order is kept, so the re-dealing
      is deterministic and the parent log's boundary rewrite can mirror it;
    - device and device-hash shards are rebuilt from the snapshot's
      fingerprint pairs, host sets from the (per-host part) dumps;
    - the disk tier's sets (already in `sets.host`, fresh) take every old
      shard's hot dump and run files, run by run, spilling past their
      budgets as usual.  The old run files are not deleted: they go behind
      the deletion barrier of new set ``k mod D`` (old shard k), and the
      new sets number their runs past every old one, so each retained
      pre-reshard generation still resolves until it rotates away.

    -> (pending uint32 arrays per new shard, shard_visited; None on the
    tier, whose sets count themselves)."""
    D = mesh.size
    K = spec.num_lanes
    rows_all = (np.concatenate(old_pending) if any(p.shape[0] for p in old_pending)
                else np.empty((0, K), np.uint32))
    if rows_all.shape[0]:
        _hi, rlo = fp_stage(spec, from_u32(rows_all, device))
        rowner = rlo.cpu().numpy() % D
    else:
        rowner = np.empty(0, np.int64)
    pending = [rows_all[rowner == d] for d in range(D)]

    def local_pairs(all_hi, all_lo):
        owner = all_lo.astype(np.int64) % D
        lens = np.bincount(owner, minlength=D).astype(np.int64)
        pairs = {}
        for d in mesh.my_shards:
            sel = np.nonzero(owner == d)[0]
            hi, lo = all_hi[sel], all_lo[sel]
            if visited_backend == "device":
                order = np.lexsort((lo, hi))
                hi, lo = hi[order], lo[order]
            pairs[d] = (from_u32(hi, mesh.device(d)), from_u32(lo, mesh.device(d)))
        return pairs, lens

    if use_disk:
        srcs = [part_arrays[f"host{p}"] for p in range(old_P)] if old_P > 1 else [snap]
        old_mans = [None] * old_D
        old_hots = [np.empty(0, np.uint64)] * old_D
        for src in srcs:
            mans = json.loads(str(src["spill_manifest"]))
            hot_flat, at = src["host_hot"], 0
            for d, ln in enumerate(src["host_hot_lens"]):
                ln = int(ln)
                if mans[d] is not None:
                    old_mans[d] = mans[d]
                    old_hots[d] = np.asarray(hot_flat[at : at + ln], np.uint64)
                at += ln
        next_seq = max((int(m["seq"]) for m in old_mans if m is not None), default=0)
        for d in mesh.my_shards:
            sets.host[d].seq = next_seq

        def deal(fps: np.ndarray) -> None:
            fo = (fps & np.uint64(_U32)).astype(np.int64) % D
            for d in mesh.my_shards:
                sel = fps[fo == d]
                if len(sel):
                    sets.host[d].insert(sel)

        for k in range(old_D):
            old_files = []
            deal(old_hots[k])
            if old_mans[k] is not None:
                shard_dir = os.path.join(spill_base, f"shard{k}")
                for m in old_mans[k]["runs"]:
                    r = SortedRun(shard_dir, m, verify=True)
                    deal(np.asarray(r.arr))
                    old_files.append(r.path)
                old_files.extend(os.path.normpath(os.path.join(shard_dir, p))
                                 for _, p in old_mans[k].get("pending_delete", ()))
            tgt = sets.host[k % D]
            if tgt is not None and old_files:
                tgt.deleter.schedule(old_files)
        return pending, None
    if visited_backend == "host":
        if old_P > 1:
            all_fps = np.concatenate([np.asarray(part_arrays[f"host{p}"]["host_fps"], np.uint64)
                                      for p in range(old_P)])
        else:
            all_fps = np.asarray(snap["host_fps"], np.uint64)
        pairs, lens = local_pairs((all_fps >> np.uint64(32)).astype(np.uint32),
                                  (all_fps & np.uint64(_U32)).astype(np.uint32))
        sets.build(pairs, lens)
    elif visited_backend == "device-hash":
        pairs, lens = local_pairs(np.asarray(snap["hash_hi"], np.uint32),
                                  np.asarray(snap["hash_lo"], np.uint32))
        sets.build(pairs, lens)
    else:
        vn_old = np.asarray(snap["vn"]).ravel()
        vhi, vlo = np.asarray(snap["vhi"], np.uint32), np.asarray(snap["vlo"], np.uint32)
        his = [vhi[d, : int(vn_old[d])] for d in range(old_D)]
        los = [vlo[d, : int(vn_old[d])] for d in range(old_D)]
        pairs, lens = local_pairs(np.concatenate(his) if his else np.empty(0, np.uint32),
                                  np.concatenate(los) if los else np.empty(0, np.uint32))
        sets.build(pairs, lens, cap=next_pow2(max(1024, 2 * int(lens.max() if lens.size else 1))))
    return pending, lens


def _compress_on(overlap_on: bool, exchange: str, model, mesh: ShardMesh) -> bool:
    """The JAX package's rule for the compressed all_to_all: with the
    overlap layer, the all_to_all exchange and fewer than 255 actions (the
    ids ride the wire as u8), where $KSPEC_EXCHANGE_COMPRESS is 1, or is
    not 0 and the shards sit on a CUDA device (the JAX package's "the
    backend is not the CPU": on one host's memory the codec is pure
    compute)."""
    env = os.environ.get(COMPRESS_ENV, "")
    return (overlap_on and exchange == "all_to_all" and len(model.actions) < 255
            and (env == "1" or (env != "0" and mesh.device(mesh.my_shards[0]).type == "cuda")))


def check_sharded(
    model,
    mesh: Optional[ShardMesh] = None,
    max_depth: Optional[int] = None,
    max_states: Optional[int] = None,
    min_bucket: int = 256,
    progress=None,
    check_deadlock: bool = False,
    chunk_size: int = 16384,
    store_trace: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    stats_path: Optional[str] = None,
    compact_shift: int = 2,
    compact_gate: int = 1024,
    exchange: str = "all_to_all",
    visited_backend: str = "device",
    mem_budget=None,
    spill_dir: Optional[str] = None,
    store: str = "auto",
    disk_budget=None,
    run=None,
    shard_heartbeat_dir: Optional[str] = None,
    overlap: Optional[bool] = None,
    pipeline: Optional[str] = None,
    device=None,
) -> CheckResult:
    """Exhaustive sharded BFS over `mesh` (default: ``ShardMesh.default``,
    one shard per device the runtime exposes, on the card unless `device`
    says "cpu"); arguments mean what they mean for the JAX engine's
    check_sharded, with its defaults and in its order.  `device` is used
    only to build the default mesh; a given mesh names its devices.

    store_trace: keep each level's rows, parents and actions in
    shard-major discovery order and report a violation with its full
    trace.  checkpoint_dir: save every `checkpoint_every` levels (keep
    `checkpoint_keep` generations) and resume from the newest that
    verifies, on this mesh or elastically on another; with store_trace,
    per-shard parent logs under ``<checkpoint_dir>/plog`` keep traces
    across a resume.  stats_path / run: the per-level records, with the
    per-shard frontier, new and (host) duplicate breakdowns; a run context
    observes on the coordinator only.  shard_heartbeat_dir (or
    $KSPEC_SHARD_HEARTBEAT_DIR, or ``<run dir>/shards``): every process
    appends one line a level to ``proc<i>.jsonl``.  exchange:
    "all_to_all" or "all_gather".  visited_backend: "device",
    "device-hash" or "host".  compact_shift/compact_gate select the
    candidate order of a chunk (``pipeline.compacts``).  overlap: the
    overlap layer (module docstring; $KSPEC_OVERLAP, default on).
    store/mem_budget/spill_dir: the disk tier, which runs on the host
    backend.  disk_budget: the resource governor's byte budget over the
    spill and checkpoint directories.  pipeline: "legacy" and "fused" run
    the per-chunk step; "device" the device-resident level
    (``ShardedDeviceLevel``) where it serves, the per-chunk step
    elsewhere.  $KSPEC_FAULT arms
    the faults of ``faults.WIRED_SHARDED``; a shard-scoped one fires only
    on the process owning its shard, and a plan naming another site is
    refused.
    """
    require_encoding_sound(model)
    pipe_name = resolve_pipeline(pipeline)
    use_disk = resolve_store(store, mem_budget)
    if visited_backend not in ("device", "device-hash", "host"):
        raise ValueError(f"visited_backend must be 'device', 'device-hash' or 'host', "
                         f"got {visited_backend!r}")
    if use_disk:
        # the disk tier spills the host level of the hierarchy
        visited_backend = "host"
    if exchange not in ("all_to_all", "all_gather"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if mesh is None:
        mesh = ShardMesh.default(resolve_device(device))
    for dev in dict.fromkeys(mesh.devices):
        resolve_device(dev)
    fault = FaultPlan.from_env()
    unwired = fault.unwired(WIRED_SHARDED)
    if unwired:
        raise ValueError(
            f"fault plan {fault.spec!r}: site(s) {', '.join(unwired)} are not wired in the "
            f"sharded engine (it wires {', '.join(sorted(f'{k}@{p}' for k, p in WIRED_SHARDED))})")
    # shard-scoped faults fire only on the process hosting the shard
    fault.set_local_shards(mesh.my_shards)
    fault.validate_shards(mesh.size)
    # the overlap layer: kspec-io carries the tier's merges, kspec-ckpt the
    # checkpoint writes; the env-replicated resolution takes every process
    # down the same path
    overlap_on = overlap_enabled(overlap)
    io_worker = AsyncWorker("kspec-io") if overlap_on else None
    ckpt_worker = (AsyncWorker("kspec-ckpt")
                   if overlap_on and checkpoint_dir is not None else None)
    try:
        return _check_sharded(
            model, mesh=mesh, max_depth=max_depth, max_states=max_states,
            min_bucket=min_bucket, progress=progress, check_deadlock=check_deadlock,
            chunk_size=chunk_size, store_trace=store_trace, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, checkpoint_keep=checkpoint_keep,
            stats_path=stats_path, compact_shift=compact_shift, compact_gate=compact_gate,
            exchange=exchange, visited_backend=visited_backend, mem_budget=mem_budget,
            spill_dir=spill_dir, use_disk=use_disk, disk_budget=disk_budget, run=run,
            shard_heartbeat_dir=shard_heartbeat_dir, pipe_name=pipe_name, fault=fault,
            io_worker=io_worker, ckpt_worker=ckpt_worker,
            compress_on=_compress_on(overlap_on, exchange, model, mesh))
    finally:
        # no worker outlives the call: a completed run drained and closed
        # them; any other ending closes them here, discarding what they hold
        close_workers((io_worker, ckpt_worker), drain=False)


def _check_sharded(model, *, mesh, max_depth, max_states, min_bucket, progress, check_deadlock,
                   chunk_size, store_trace, checkpoint_dir, checkpoint_every, checkpoint_keep,
                   stats_path, compact_shift, compact_gate, exchange, visited_backend,
                   mem_budget, spill_dir, use_disk, disk_budget, run, shard_heartbeat_dir,
                   pipe_name, fault, io_worker, ckpt_worker, compress_on) -> CheckResult:
    """check_sharded past its argument checks, with the overlap layer's
    workers (None where the layer is off, or kspec-ckpt without
    checkpoints) and the compression decision."""
    overlap_on = io_worker is not None
    workers = (io_worker, ckpt_worker)
    D = mesh.size
    my_proc, my_shards = mesh.my_proc, mesh.my_shards
    P = process_count()

    hb_dir = shard_heartbeat_dir or os.environ.get("KSPEC_SHARD_HEARTBEAT_DIR")
    if hb_dir is None and run is not None:
        hb_dir = os.path.join(run.dir, "shards")
    if run is not None and not is_coordinator():
        run = None
    obs_ = RunObserver(run, stats_path, engine="sharded")
    spec = model.spec
    K = spec.num_lanes
    C = model.total_fanout
    home = mesh.device(my_shards[0])

    inits = [{k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in s.items()}
             for s in model.init_states()]
    init_packed = np.unique(torch.stack([spec.pack(s) for s in inits]).numpy(), axis=0)
    n0 = init_packed.shape[0]

    def decode_row(row):
        if isinstance(row, np.ndarray):
            row = torch.from_numpy(row.astype(np.int64))
        st = {k: v.cpu().numpy() for k, v in spec.unpack(row).items()}
        return model.decode(st) if model.decode else st

    t0 = time.perf_counter()
    init_t = torch.from_numpy(init_packed).to(home)
    if model.invariants:
        st0 = spec.unpack(init_t)
        for inv in model.invariants:
            ok = inv.pred(st0).cpu().numpy()
            if not ok.all():
                dec = decode_row(init_packed[int(np.argmax(~ok))])
                res = CheckResult(model.name, [n0], n0, 0,
                                  Violation(invariant=inv.name, depth=0, state=dec,
                                            trace=[("<init>", dec)]),
                                  time.perf_counter() - t0, 0.0, stats={"devices": D})
                obs_.finish(res)
                obs_.close()
                return res
    obs_.config(model=model.name, devices=D, exchange=exchange,
                visited_backend=visited_backend, store="disk" if use_disk else "ram",
                mem_budget=mem_budget, checkpoint_dir=checkpoint_dir,
                platform="gpu" if home.type == "cuda" else home.type)

    # the inits, dealt to their owners; each shard's set
    hi0, lo0 = (t.cpu().numpy() for t in fp_stage(spec, init_t))
    owner0 = lo0 % D
    sets = _ShardSets(visited_backend, mesh)
    pending = [init_packed[owner0 == d] for d in range(D)]  # uint32 lanes kept as int64
    shard_visited = np.bincount(owner0, minlength=D).astype(np.int64)

    spill_base = ephemeral_spill = None
    if use_disk:
        budget = parse_mem_budget(mem_budget) if mem_budget is not None else DEFAULT_MEM_BUDGET
        spill_base = spill_dir or (os.path.join(checkpoint_dir, "spill") if checkpoint_dir
                                   else None)
        if spill_base is None:
            # anonymous spill space, removed after a completed run
            spill_base = ephemeral_spill = tempfile.mkdtemp(prefix="kspec-spill-")
        # one tiered set a shard this process owns, each with its share of
        # the budget (mem_budget is per process, as in check()); the inits
        # go in at the fresh/resume decision (a resume must not wipe the
        # runs its manifest references)
        for d in my_shards:
            sets.host[d] = TieredFpSet(
                os.path.join(spill_base, f"shard{d}"), max(1, budget // len(my_shards)),
                runs_per_merge=int(os.environ.get("KSPEC_SPILL_RUNS_PER_MERGE", "8")),
                gc_barrier=checkpoint_keep if checkpoint_dir else 0,
                fault_plan=fault, merge_worker=io_worker)

    def init_pairs():
        pairs = {}
        for d in my_shards:
            sel = np.nonzero(owner0 == d)[0]
            h, lo = hi0[sel], lo0[sel]
            if visited_backend == "device":
                order = np.lexsort((lo, h))
                h, lo = h[order], lo[order]
            pairs[d] = (torch.from_numpy(h.astype(np.int64)).to(mesh.device(d)),
                        torch.from_numpy(lo.astype(np.int64)).to(mesh.device(d)))
        return pairs

    chunk = next_pow2(max(32, chunk_size))
    levels = [n0]
    total = n0
    depth = 0
    violation = None
    result_levels: list = []
    exch_bytes_total = exch_raw_bytes_total = 0
    staged_peak = 0  # most chunks staged at once (<= 2)

    chain = _integ.LevelDigestChain() if _integ.enabled() else None
    hb_path = None
    if hb_dir:
        os.makedirs(hb_dir, exist_ok=True)
        hb_path = os.path.join(hb_dir, f"proc{my_proc}.jsonl")

    def shard_beat(done_depth: int, **extra) -> None:
        if hb_path is not None:
            append_jsonl(hb_path, heartbeat_record(
                "shard-heartbeat", proc=int(my_proc), pid=os.getpid(), shards=my_shards,
                depth=int(done_depth), **extra))

    chunk_retry = ChunkRetryHandler.from_env("[sharded]")
    ckpt_store = None
    last_ckpt_depth = None
    resumed = elastic_resumed = False
    plog = None
    inv_names = ",".join(sorted(i.name for i in model.invariants))
    # the mesh layout is NOT part of the identity: a checkpoint binds to the
    # search, and another layout resumes it elastically; the writing layout
    # is stamped as mesh_D / mesh_P instead
    fields_ident = ",".join(f"{f.name}:{f.shape}:{f.lo}:{f.hi}" for f in spec.fields) + (
        "|store=disk" if use_disk else "")
    ckpt_ident = (f"{model.name}|lanes={K}|backend={visited_backend}|"
                  f"inv={inv_names}|dl={check_deadlock}|" + fields_ident)
    # the pre-elastic ident baked the layout in: accepted for THIS mesh only
    ckpt_ident_legacy = (f"{model.name}|lanes={K}|D={D}|P={P}|backend={visited_backend}|"
                         f"inv={inv_names}|dl={check_deadlock}|" + fields_ident)
    if checkpoint_dir is not None:
        want_trace = store_trace
        store_trace = False
        last_ckpt_depth = 0
        checkpoint_every = max(1, int(checkpoint_every))

        def spill_ref_errors(arrays: dict) -> list:
            """The disk tier's load validator: every spill run a generation
            references must pass its CRC, else the generation falls back to
            an older one (flip@spill)."""
            if not use_disk or "spill_manifest" not in arrays:
                return []
            errs = []
            for d, man in enumerate(json.loads(str(arrays["spill_manifest"]))):
                errs += _integ.spill_run_errors(os.path.join(spill_base, f"shard{d}"),
                                                (man or {}).get("runs", ()))
            return errs

        ckpt_store = CheckpointStore(
            checkpoint_dir, CHECKPOINT_BASENAME, ident=ckpt_ident, keep=checkpoint_keep,
            fault_plan=fault, ident_aliases=(ckpt_ident_legacy,),
            validators=((_integ.checkpoint_chain_errors, spill_ref_errors) if chain is not None
                        else (spill_ref_errors,)),
        )
        if ckpt_worker is not None:
            ckpt_store.attach_writer(ckpt_worker)
        if want_trace:
            plog = ShardedParentLog(os.path.join(checkpoint_dir, "plog"), K, D,
                                    local_shards=my_shards, epoch_writer=is_coordinator(),
                                    fault_plan=fault)

        def parts_for(main):
            # the per-host parts a main needs, from the layout IT records: a
            # same-layout resume reads this process's part, an elastic one
            # every old host's; a stamp-less legacy main passed the ident
            # check through the same-layout alias, so its layout is ours
            old_P_ = int(main["mesh_P"]) if "mesh_P" in main else P
            old_D_ = int(main["mesh_D"]) if "mesh_D" in main else D
            if visited_backend != "host" or old_P_ <= 1:
                return ()
            if old_D_ == D and old_P_ == P:
                return (f"host{my_proc}",)
            return tuple(f"host{p}" for p in range(old_P_))

        loaded = ckpt_store.load(parts=parts_for)
        if loaded is not None:
            resumed = True
            snap, part_arrays, _gen = loaded
            if chain is not None:
                chain = (_integ.LevelDigestChain.from_array(snap["digest_chain"])
                         if "digest_chain" in snap
                         else _integ.LevelDigestChain.from_levels(snap["levels"].tolist()))
            old_D = int(snap["mesh_D"]) if "mesh_D" in snap else D
            old_P = int(snap["mesh_P"]) if "mesh_P" in snap else P
            elastic_resumed = old_D != D or old_P != P
            flat, pending, at = snap["pending"], [], 0
            for ln in snap["pending_lens"]:
                pending.append(np.asarray(flat[at : at + int(ln)], np.uint32))
                at += int(ln)
            levels = snap["levels"].tolist()
            total = int(snap["total"])
            depth = last_ckpt_depth = int(snap["depth"])
            # crash faults at or below the resume level count as fired
            fault.set_start_depth(depth)
            if elastic_resumed:
                pending, lens = _elastic_reshard(
                    snap, part_arrays, old_D, old_P, pending, mesh=mesh, spec=spec,
                    visited_backend=visited_backend, sets=sets, device=home,
                    use_disk=use_disk, spill_base=spill_base)
                if lens is not None:
                    shard_visited = lens
                if plog is not None and is_multiprocess():
                    # the boundary rewrite replaces segments other processes
                    # may be reading: a multi-process elastic resume stays
                    # trace-less (as in the JAX package)
                    plog = None
                if plog is not None and not plog.reshard(depth, pending):
                    plog = None  # old segments unreadable: trace-less
                from ..obs import tracer as _obs_t

                _obs_t.event("elastic-reshard", depth=depth, from_shards=old_D, to_shards=D,
                             from_procs=old_P, to_procs=P)
                _met.inc("kspec_elastic_reshards_total")
            elif use_disk:
                # each tiered set restored in place from its run manifest and
                # hot dump (the runs stay on disk; the checkpoint references
                # them)
                src = part_arrays[f"host{my_proc}"] if is_multiprocess() else snap
                mans = json.loads(str(src["spill_manifest"]))
                hot_flat, at = src["host_hot"], 0
                for d, ln in enumerate(src["host_hot_lens"]):
                    ln = int(ln)
                    if sets.host[d] is not None:
                        sets.host[d].restore(mans[d], hot_flat[at : at + ln])
                    at += ln
            elif visited_backend == "host":
                src = part_arrays[f"host{my_proc}"] if is_multiprocess() else snap
                fps_flat, lens = np.asarray(src["host_fps"], np.uint64), src["host_lens"]
                starts = np.concatenate([[0], np.cumsum(lens)])
                pairs = {}
                for d in my_shards:
                    f = fps_flat[int(starts[d]) : int(starts[d + 1])]
                    pairs[d] = (from_u32((f >> np.uint64(32)).astype(np.uint32), mesh.device(d)),
                                from_u32((f & np.uint64(_U32)).astype(np.uint32), mesh.device(d)))
                sets.build(pairs, lens)
            elif visited_backend == "device-hash":
                lens = np.asarray(snap["hash_lens"], np.int64)
                shard_visited = lens.copy()
                starts = np.concatenate([[0], np.cumsum(lens)])
                pairs = {d: (from_u32(snap["hash_hi"][int(starts[d]) : int(starts[d + 1])],
                                      mesh.device(d)),
                             from_u32(snap["hash_lo"][int(starts[d]) : int(starts[d + 1])],
                                      mesh.device(d))) for d in my_shards}
                sets.build(pairs, lens)
            else:
                vn = np.asarray(snap["vn"]).ravel()
                pairs = {d: (from_u32(snap["vhi"][d, : int(vn[d])], mesh.device(d)),
                             from_u32(snap["vlo"][d, : int(vn[d])], mesh.device(d)))
                         for d in my_shards}
                sets.build(pairs, vn, cap=int(snap["vcap"]))
                shard_visited = vn.astype(np.int64)
            if plog is not None and not elastic_resumed and not plog.resume(depth):
                plog = None  # no resolvable epochs: trace-less
        if is_multiprocess():
            # split-brain guard: every process must resume the same level
            votes = fetch_global(torch.tensor([[depth]], dtype=torch.int64))
            if len(set(votes.ravel().tolist())) != 1:
                raise ValueError(
                    "checkpoint resume disagreement: processes verified different checkpoint "
                    "generations (per-host part corruption?) — restore or delete "
                    f"{checkpoint_dir} and restart")
    if not resumed:
        if use_disk:
            # a fresh run on the tier: each owned shard claims its run
            # directory and takes its init fingerprints
            for d in my_shards:
                sets.host[d].start_fresh()
                sel = np.nonzero(owner0 == d)[0]
                if len(sel):
                    sets.host[d].insert(_integ.pair_u64(hi0[sel], lo0[sel]))
        else:
            sets.build(init_pairs(), shard_visited,
                       cap=next_pow2(max(1024, 4 * n0)) if visited_backend == "device" else None)
        if chain is not None:
            chain.fold(_integ.pair_u64(hi0, lo0))
            chain.seal(0, n0)
    # the pending rows of every shard, on this process's device
    pending = [from_u32(p, home) for p in pending]
    step = _make_sharded_step(model, mesh, exchange, visited_backend, compact_shift,
                              compact_gate, check_deadlock)
    sdev = (ShardedDeviceLevel(model, mesh, visited_backend, check_deadlock, compact_shift,
                               compact_gate, exchange) if pipe_name == "device" else None)

    # the async writer's bookkeeping: `last_ckpt_depth` is the newest
    # submitted save, `ckpt_durable_depth` the newest promoted one, on which
    # level-keyed faults defer; each save's completion callback runs on
    # this thread, in submission order, as saves promote
    ckpt_durable_depth = last_ckpt_depth
    ckpt_cbs: list = []

    def ckpt_poll(block: bool = False) -> None:
        nonlocal ckpt_durable_depth
        if ckpt_worker is None or ckpt_store is None:
            return
        for d, path in (ckpt_store.drain_async() if block else ckpt_store.poll_async()):
            cb = ckpt_cbs.pop(0) if ckpt_cbs else None
            if cb is not None:
                cb(path)
            ckpt_durable_depth = d if ckpt_durable_depth is None else max(ckpt_durable_depth, d)

    def store_save(arrays, part=None, on_done=None, sync: bool = False) -> None:
        """One checkpoint-store write, on the writer thread or (sync, or
        the layer off) here; `on_done(path)` runs on this thread once the
        write promoted."""
        nonlocal ckpt_durable_depth
        if ckpt_worker is not None and not sync:
            ckpt_cbs.append(on_done)
            ckpt_store.save_async(depth, arrays, part=part)
            return
        path = ckpt_store.save(depth, arrays, part=part)
        if on_done is not None:
            on_done(path)
        ckpt_durable_depth = depth if ckpt_durable_depth is None else max(ckpt_durable_depth,
                                                                          depth)

    def advance_spill_gc(marks=None) -> None:
        # a new durable generation: each tiered set's deletion barrier
        # advances, for the files scheduled before the save's snapshot
        # (`marks`) when the save was async
        if use_disk:
            for d in my_shards:
                s = sets.host[d]
                s.deleter.on_save(upto=None if marks is None else marks.get(id(s)))

    def gc_marks():
        return {id(sets.host[d]): sets.host[d].deleter.mark() for d in my_shards} \
            if use_disk else None

    def levels_for_save():
        levels_arr = np.asarray(levels)
        if chain is not None and chain.anchored and fault.flip("ckpt", depth,
                                                                ckpt_depth=ckpt_durable_depth):
            levels_arr = levels_arr.copy()
            _integ.flip_bit(levels_arr)
        return levels_arr

    def chain_stamp() -> dict:
        return {"digest_chain": chain.to_array()} if chain is not None and chain.anchored else {}

    def readback(path: str, at_depth: int) -> None:
        if chain is not None and chain.anchored:
            _integ.readback_chain(path, depth=at_depth)

    def pending_arrays() -> dict:
        pend = [to_u32(p).reshape(-1, K) for p in pending]
        return dict(pending=np.concatenate(pend) if any(p.shape[0] for p in pend)
                    else np.empty((0, K), np.uint32),
                    pending_lens=np.asarray([p.shape[0] for p in pend]))

    def save_checkpoint(sync: bool = False):
        if use_disk:
            # the run manifests and hot dumps: the runs ARE the durable
            # state, the checkpoint references them
            hots = [sets.host[d].hot_dump() if sets.host[d] is not None
                    else np.empty(0, np.uint64) for d in range(D)]
            payload = {
                "host_hot": np.concatenate(hots),
                "host_hot_lens": np.asarray([len(x) for x in hots]),
                "spill_manifest": json.dumps([s.manifest() if s is not None else None
                                              for s in sets.host]),
                "mesh_D": D,
                "mesh_P": P,
            }
            marks = gc_marks()
            if is_multiprocess():
                # a non-coordinator's part is its only write: its barrier
                # advances when the part promotes
                store_save(payload, part=f"host{my_proc}",
                           on_done=None if is_coordinator()
                           else lambda _p, m=marks: advance_spill_gc(m), sync=sync)
                extra = {}
            else:
                extra = payload
            if not is_coordinator():
                return
            main = dict(**pending_arrays(), vcap=sets.cap, levels=levels_for_save(),
                        total=total, **extra, **chain_stamp())
            main["mesh_D"] = D
            main["mesh_P"] = P

            def main_done(path, m=marks, d=depth):
                advance_spill_gc(m)
                readback(path, d)

            store_save(main, on_done=main_done, sync=sync)
            return
        if visited_backend == "host":
            dumps = [s.dump() if s is not None else np.empty(0, np.uint64) for s in sets.host]
            if is_multiprocess():
                # each process persists its own shards in a part file; the
                # mesh stamps pair parts with mains
                store_save(dict(host_fps=np.concatenate(dumps),
                                host_lens=np.asarray([len(x) for x in dumps]), mesh_D=D,
                                mesh_P=P), part=f"host{my_proc}", sync=sync)
                extra = {}
            else:
                extra = {"host_fps": np.concatenate(dumps) if dumps else np.empty(0, np.uint64),
                         "host_lens": np.asarray([len(x) for x in dumps])}
        elif visited_backend == "device-hash":
            pairs = sets.dump_pairs()
            extra = {"hash_hi": np.concatenate([h for h, _ in pairs]),
                     "hash_lo": np.concatenate([lo for _, lo in pairs]),
                     "hash_lens": np.asarray([len(h) for h, _ in pairs])}
        else:
            pairs = sets.dump_pairs()
            vn = np.asarray([len(h) for h, _ in pairs], np.int32)
            w = int(vn.max()) if vn.size else 0
            vhi = np.full((D, w), _U32, np.uint32)
            vlo = np.full((D, w), _U32, np.uint32)
            for d, (h, lo) in enumerate(pairs):
                vhi[d, : len(h)], vlo[d, : len(lo)] = h, lo
            extra = {"vhi": vhi, "vlo": vlo, "vn": vn}
        if chain is not None and chain.anchored:
            # flip@fpset, then the save-time self-check of the dump against
            # the chain (a multi-process host run's dumps are partial)
            pk = {"host": None if is_multiprocess() else "host_fps", "device-hash": "hash_hi",
                  "device": "vhi"}[visited_backend]
            if pk is not None:
                if fault.flip("fpset", depth, ckpt_depth=last_ckpt_depth):
                    extra[pk] = np.array(extra[pk], copy=True)
                    _integ.flip_bit(extra[pk])
                _integ.count_check()
                chain.verify_visited(_integ.visited_fps(extra), depth=depth)
        if not is_coordinator():
            return
        store_save(dict(**pending_arrays(), vcap=sets.cap, levels=levels_for_save(),
                        total=total, mesh_D=D, mesh_P=P, **extra, **chain_stamp()),
                   on_done=lambda p, d=depth: readback(p, d), sync=sync)

    # the resource governor: per process, over its spill and checkpoint
    # directories (in a fleet the breaching process exits typed and the
    # fleet supervisor classifies it)
    governor = ResourceGovernor.from_env(disk_budget=disk_budget,
                                         watch_dirs=[spill_base, checkpoint_dir],
                                         fault_plan=fault)

    def final_save():
        """Checkpoint-then-clean-exit: the level just completed, off the
        cadence if need be, synchronously and after the async tail (the
        typed exit promises a durable state)."""
        nonlocal last_ckpt_depth
        if ckpt_store is None:
            return
        ckpt_poll(block=True)
        if last_ckpt_depth != depth or ckpt_durable_depth != depth:
            save_checkpoint(sync=True)
            last_ckpt_depth = depth

    def reclaim():
        """Soft-breach reclamation: tmp janitor and eager merges per owned
        shard (each merge worker quiesced before its directory is swept),
        a fresh checkpoint, the older generations pruned (coordinator),
        each owned shard's deletion barrier flushed."""
        nonlocal last_ckpt_depth
        merged = False
        if use_disk:
            for d in my_shards:
                s = sets.host[d]
                s.quiesce()
                sweep_tmp(s.dir)
                if len(s.runs) > 1:
                    s.merge()
                    merged = True
        if ckpt_store is not None:
            ckpt_poll(block=True)
            if merged or last_ckpt_depth != depth or ckpt_durable_depth != depth:
                save_checkpoint(sync=True)
                last_ckpt_depth = depth
            if is_coordinator():
                ckpt_store.prune(keep_gens=1)
            if use_disk:
                for d in my_shards:
                    sets.host[d].deleter.flush()

    if elastic_resumed:
        # one generation in the new layout at once: a crash before the next
        # save resumes into it without re-dealing, and the tier's re-dealt
        # runs are referenced before any old run can age out
        save_checkpoint()

    trace_store = []
    if store_trace:
        none = torch.full((n0,), -1, dtype=torch.int64, device=home)
        trace_store.append((torch.cat(pending), none, none))
    if plog is not None and not resumed:
        plog.start_fresh()
        plog.write_level(0, [to_u32(p).reshape(-1, K) for p in pending],
                         [np.full(p.shape[0], -1, np.int64) for p in pending],
                         [np.full(p.shape[0], -1, np.int64) for p in pending])
    collect_trace = store_trace or plog is not None

    def build_violation(inv_name, d_level, idx):
        if store_trace:
            return walk_trace(trace_store, model.actions, decode_row, inv_name, d_level, idx)
        if plog is not None and plog.has_levels(d_level):
            return walk_trace(plog.view(), model.actions, decode_row, inv_name, d_level, idx)
        return None

    def owned_tiers():
        return [sets.host[d] for d in my_shards] if use_disk else []

    n_inv = len(model.invariants)
    A = len(model.actions)
    # the staged commit: the host backend's chunks touch no visited state
    # until their commit, so chunk k+1 can be dispatched before chunk k is
    # committed; the device backends carry their sets from chunk to chunk
    stage_chunks = overlap_on and visited_backend == "host"
    shard_beat(depth, event="start", resumed=bool(resumed))
    cut = False
    exhausted = integrity_fail = None
    try:
        while any(p.shape[0] for p in pending):
            # the async join point: adopt finished merges and checkpoint
            # promotes, surface the workers' errors; blocking under an armed
            # fault plan, so an injection never depends on thread timing
            ckpt_poll(block=bool(fault.specs))
            for s in owned_tiers():
                if fault.specs:
                    s.quiesce()
                s.poll_merge()
            lvl_io0 = worker_counters(workers)
            fault.crash("level", depth, ckpt_depth=ckpt_durable_depth)
            if chain is not None:
                sp = fault.flip("frontier", depth, ckpt_depth=ckpt_durable_depth)
                if sp:
                    # a shard scope targets that shard's pending rows (the
                    # first non-empty one when it holds none this level)
                    d0 = sp.shard if sp.shard is not None else 0
                    if pending[d0].shape[0] == 0:
                        d0 = next((d for d in range(D) if pending[d].shape[0]), d0)
                    u32 = to_u32(pending[d0])
                    _integ.flip_bit(u32)
                    pending[d0] = from_u32(u32, home)
                # the frontier verify: the shards' combined multiset against
                # the entry sealed at discovery (one K1 launch over them all)
                keys = dedup.pair_key(*fp_stage(spec, torch.cat(pending)))
                _integ.count_check()
                chain.verify_level(depth, keys.cpu().numpy().view(np.uint64))
            if max_depth is not None and depth >= max_depth:
                cut = True
                break
            if max_states is not None and total >= max_states:
                cut = True
                break
            t_level = time.perf_counter()
            lens = [p.shape[0] for p in pending]
            obs_.level_begin(depth + 1, int(sum(lens)))
            governor.level_begin(depth + 1)  # arm the per-level deadline
            next_pending = [[] for _ in range(D)]
            next_parent = [[] for _ in range(D)]
            next_act = [[] for _ in range(D)]
            lvl_act_en = np.zeros(A, np.int64)
            lvl_new_per_shard = np.zeros(D, np.int64)
            lvl_en_per_shard = np.zeros(D, np.int64)
            lvl_recv_per_shard = np.zeros(D, np.int64)
            lvl_exch_bytes = lvl_exch_raw_bytes = 0
            lvl_dispatches = 0
            lvl_probe_ms = 0.0  # the device level's batched host inserts
            offs = [0] * D
            prev_base = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            verdict = None  # (invariant name, shard, frontier row, level index)

            def build_chunk():
                """The next chunk's rows of every local shard, or None when
                the level is done."""
                rem = max(n - o for n, o in zip(lens, offs))
                if rem <= 0:
                    return None
                governor.poll(depth)  # the deadline watchdog
                bucket = min(next_pow2(max(rem, min_bucket // D, 32)), chunk)
                chunk_off = list(offs)
                took = [min(bucket, lens[d] - offs[d]) for d in range(D)]
                for d in range(D):
                    offs[d] += took[d]
                frontier = {d: pending[d][chunk_off[d] : chunk_off[d] + took[d]].to(mesh.device(d))
                            for d in my_shards}
                base = {d: int(prev_base[d] + chunk_off[d]) for d in my_shards}
                return bucket, frontier, base, chunk_off, time.perf_counter()

            def dispatch(ctx):
                """The chunk's step under the failure ladder."""
                nonlocal chunk, lvl_dispatches
                bucket, frontier, base = ctx[:3]
                chunk_retry.reset_chunk()
                while True:
                    try:
                        injected = fault.chunk_error(escalated=False)
                        if injected is not None:
                            raise injected
                        sets.reserve(shard_visited)
                        out = step(frontier, base, bucket, sets, compress_on)
                        lvl_dispatches += 1
                        return out
                    except Exception as e:  # noqa: BLE001 -- the failure ladder decides
                        # transient: re-run the attempt; a device allocation
                        # failure halves the chunk from the next one on, and
                        # re-runs this one (single process only: a lone
                        # process retrying would desync the collectives)
                        action = chunk_retry.handle(e, escalated=False, depth=depth,
                                                    retry_transient=not is_multiprocess())
                        if action == "degrade_chunk":
                            chunk = max(next_pow2(max(32, min_bucket // D)), chunk >> 1)

            def commit(ctx, out) -> bool:
                """One dispatched chunk's commit, in dispatch order: the
                framing check, the verdicts, the owners' new states (the host
                sets insert here), the chain fold.  -> True on a verdict."""
                nonlocal verdict, lvl_exch_bytes, lvl_exch_raw_bytes, shard_visited
                nonlocal lvl_recv_per_shard, lvl_new_per_shard, lvl_act_en, lvl_en_per_shard
                bucket, _frontier, _base, chunk_off, t_chunk = ctx
                heads, outs, wire = out
                # every shard's flags, digests and winners, on every process
                g = fetch_global(torch.stack([heads[d].to(home) for d in my_shards]))
                o = 0
                viol_any = g[:, o : o + n_inv]
                viol_idx = g[:, o + n_inv : o + 2 * n_inv]
                o += 2 * n_inv
                dl_any, dl_idx = g[:, o], g[:, o + 1]
                act_en = g[:, o + 2 : o + 2 + A]
                sd = g[:, o + 2 + A : o + 7 + A]
                rd = np.array(g[:, o + 7 + A : o + 12 + A])
                # the exchange framing check: across the mesh the received
                # multiset (decoded, when compressed) combines to exactly the
                # sent one; flip@exchange drives the detector's observation
                if chain is not None:
                    sp = fault.flip("exchange", depth + 1, ckpt_depth=ckpt_durable_depth)
                    if sp:
                        rd[sp.shard if sp.shard is not None else 0, 1] ^= 0x10
                    _integ.count_check()
                    if _combine_digs(sd) != _combine_digs(rd):
                        raise IntegrityError(
                            "exchange",
                            f"exchange payload framing mismatch at level {depth + 1}: sent "
                            f"digest {_combine_digs(sd)} != received {_combine_digs(rd)} "
                            f"({exchange}; a routed fingerprint was corrupted in flight)",
                            depth=depth)
                if exchange == "all_to_all":
                    lvl_exch_bytes += wire["sent"]
                    lvl_exch_raw_bytes += wire["raw"]
                obs_.chunk_span("exchange", time.perf_counter() - t_chunk, depth=depth,
                                bucket=bucket, exchange=exchange, compressed=wire["compressed"])
                # the chunk's verdicts (the states expanded are level `depth`)
                if viol_any.any():
                    inv_i = int(np.argmax(viol_any.any(axis=0)))
                    d = int(np.argmax(viol_any[:, inv_i]))
                    idx = int(viol_idx[d, inv_i])
                    verdict = (model.invariants[inv_i].name, d, chunk_off[d] + idx,
                               int(prev_base[d] + chunk_off[d] + idx))
                    return True
                if check_deadlock and dl_any.any():
                    d = int(np.argmax(dl_any))
                    idx = int(dl_idx[d])
                    verdict = ("Deadlock", d, chunk_off[d] + idx,
                               int(prev_base[d] + chunk_off[d] + idx))
                    return True
                got = [t.to(home) for t in gather_rows([outs[d] for d in my_shards], K + 4)]
                counts = np.asarray([t.shape[0] for t in got], np.int64)
                lvl_recv_per_shard += counts
                if visited_backend == "host" and counts.any():
                    # each shard's owner inserts its first copies in key
                    # order; the masks are OR-merged, so every process takes
                    # the same novelty decision
                    masks = np.zeros((D, int(counts.max())), bool)
                    for d in range(D):
                        if counts[d] and sets.host[d] is not None:
                            keys = dedup.pair_key(got[d][:, K + 2], got[d][:, K + 3])
                            masks[d, : counts[d]] = sets.host[d].insert(
                                keys.cpu().numpy().view(np.uint64))
                    masks = or_across_processes(masks)
                newc = np.zeros(D, np.int64)
                for d in range(D):
                    w = got[d]
                    if visited_backend == "host" and w.shape[0]:
                        w = w[torch.from_numpy(masks[d, : w.shape[0]]).to(w.device)]
                    if not w.shape[0]:
                        continue
                    next_pending[d].append(w[:, :K])
                    if chain is not None:
                        chain.fold(dedup.pair_key(w[:, K + 2], w[:, K + 3]).cpu().numpy()
                                   .view(np.uint64))
                    if collect_trace:
                        next_parent[d].append(w[:, K])
                        next_act[d].append(w[:, K + 1])
                    newc[d] = w.shape[0]
                lvl_new_per_shard += newc
                shard_visited += newc
                if obs_.collect:
                    lvl_act_en += act_en.sum(axis=0)
                    lvl_en_per_shard += act_en.sum(axis=1)
                return False

            def run_device_level():
                """The level's full-size gated chunks as one queued level
                (``ShardedDeviceLevel``), with at most one re-dispatch at
                the exact widths, committed as the per-chunk commits would
                have: on success `offs` advances past the handled prefix
                (the tail runs per chunk below); on a failure the level is
                marked fallen back and `offs` stays (the per-chunk path runs
                the whole level)."""
                nonlocal verdict, lvl_exch_bytes, lvl_exch_raw_bytes, lvl_dispatches
                nonlocal lvl_probe_ms, shard_visited, lvl_recv_per_shard, lvl_new_per_shard
                nonlocal lvl_act_en, lvl_en_per_shard
                plan = sdev.plan_level(lens, chunk, min_bucket)
                if plan is None:
                    return
                B, nc = plan
                chunk_retry.reset_chunk()
                widths = sdev.widths(B)
                T = sum(widths)
                W = _default_dest_w(T, D)
                R = D * W if exchange == "all_to_all" else D * T
                LN = devlevel.level_new_capacity(T, sdev.ln_hw, nc * R)
                compress = compress_on
                exact = False
                dispatched = 0
                t0l = time.perf_counter()
                while True:
                    try:
                        injected = fault.chunk_error(escalated=True)
                        if injected is not None:
                            raise injected
                        vkeys = None
                        if not sdev.host_mode:
                            # the sorted shards grown for the level's merge
                            need = max_across_processes(max(sets.vn[d] for d in my_shards)) \
                                + min(nc * R, LN + R)
                            if need > sets.cap:
                                sets.cap = next_pow2(need)
                                sets.keys = _grow_sorted_shards(sets.keys, sets.cap)
                            vkeys = sets.keys
                        st = sdev.queue_level(pending, lens, prev_base, B, nc, widths, LN, W,
                                              compress, vkeys, sets.vn)
                        got = sdev.read_level(st)
                        dispatched += 1
                        lvl_dispatches += 1
                    except Exception as e:  # noqa: BLE001 -- the failure ladder decides
                        action = chunk_retry.handle(e, escalated=True, depth=depth,
                                                    retry_transient=not is_multiprocess())
                        if action == "retry":
                            continue
                        sdev.mark_fallback(f"{type(e).__name__}: {e}"[:200], depth)
                        return
                    if got.ovf and got.vkind == 0:
                        if exact:
                            raise RuntimeError("sharded device level overflowed at its exact "
                                               "widths and safe bound")
                        # a segment, a bucket, the codec's budget or the
                        # level-new set overflowed: once more from the
                        # pre-level state at the measured maxima, the full
                        # per-owner width (the raw wire cannot overflow at
                        # W = T) and the safe level-new bound
                        st = None
                        widths = sdev.exact_widths(B, got.agmax.max(axis=0))
                        T = sum(widths)
                        W = T
                        R = D * W if exchange == "all_to_all" else D * T
                        LN = devlevel.level_new_bound(nc * R)
                        compress = False
                        exact = True
                        continue
                    break
                counts = got.on
                sdev.observe(got.agmax.max(axis=0), B, int(counts.max()))
                # the exchange framing check over the level's accumulators
                # (with a verdict: over the clean chunks up to it)
                if chain is not None:
                    rd = got.racc.copy()
                    sp = fault.flip("exchange", depth + 1, ckpt_depth=ckpt_durable_depth)
                    if sp:
                        rd[sp.shard if sp.shard is not None else 0, 1] ^= 0x10
                    _integ.count_check()
                    if _combine_digs(got.sacc) != _combine_digs(rd):
                        raise IntegrityError(
                            "exchange",
                            f"exchange payload framing mismatch across level {depth + 1}: sent "
                            f"digest {_combine_digs(got.sacc)} != received {_combine_digs(rd)} "
                            f"({exchange}, device level program; a routed fingerprint was "
                            f"corrupted in flight)", depth=depth)
                obs_.chunk_span("exchange-level", time.perf_counter() - t0l, depth=depth,
                                bucket=B, chunks=nc, launches=dispatched, exchange=exchange,
                                compressed=compress)
                if exchange == "all_to_all":
                    # the clean chunks at the committed dispatch's widths
                    raw_b = _raw_bytes(D, W, K)
                    sent_b = (_compressed_bytes(D, W, max(32, W // 2),
                                                fpcompress.default_stream_words(W), K)
                              if compress else raw_b)
                    lvl_exch_bytes += got.nclean * sent_b
                    lvl_exch_raw_bytes += got.nclean * raw_b
                if got.vkind:
                    name = (model.invariants[got.vinv].name if got.vkind == 1 else "Deadlock")
                    verdict = (name, got.vshard, got.vidx,
                               int(prev_base[got.vshard] + got.vidx))
                    for d in range(D):
                        offs[d] = lens[d]  # the tail is never dispatched
                    return
                # every shard's winners (lanes, parent, action), on every process
                outs = [t.to(home) for t in gather_rows(
                    [torch.cat([s.orows[: counts[d]], s.opar[: counts[d], None],
                                s.oact[: counts[d], None]], dim=1)
                     for d, s in st.shards.items()], K + 2, lens=counts)]
                if sdev.host_mode:
                    # one batched insert a shard, by its owner; the masks
                    # OR-merged, so every process takes the same decision
                    t_probe = time.perf_counter()
                    cmax = int(counts.max())
                    masks = np.zeros((D, max(cmax, 1)), bool)
                    if cmax:
                        for d in range(D):
                            c = int(counts[d])
                            s = sets.host[d]
                            if c and s is not None:
                                fps = np.ascontiguousarray(got.keys[d, :c]).view(np.uint64)
                                masks[d, :c] = (s.insert_level(fps) if hasattr(s, "insert_level")
                                                else s.insert(fps)).astype(bool)
                        masks = or_across_processes(masks)
                    newc = np.zeros(D, np.int64)
                    for d in range(D):
                        c = int(counts[d])
                        if not c:
                            continue
                        w = outs[d][torch.from_numpy(masks[d, :c]).to(outs[d].device)]
                        if not w.shape[0]:
                            continue
                        next_pending[d].append(w[:, :K])
                        if chain is not None:
                            chain.fold(_integ.fingerprint_rows(to_u32(w[:, :K]), spec.exact64))
                        if collect_trace:
                            next_parent[d].append(w[:, K])
                            next_act[d].append(w[:, K + 1])
                        newc[d] = w.shape[0]
                    probe_s = time.perf_counter() - t_probe
                    lvl_probe_ms += probe_s * 1e3
                    obs_.chunk_span("host-probe", probe_s, depth=depth, rows=int(counts.sum()),
                                    new=int(newc.sum()), batched="level")
                else:
                    for d, s in st.shards.items():
                        sets.keys[d] = s.merged
                        sets.vn[d] += int(counts[d])
                    for d in range(D):
                        if counts[d]:
                            next_pending[d].append(outs[d][:, :K])
                            if collect_trace:
                                next_parent[d].append(outs[d][:, K])
                                next_act[d].append(outs[d][:, K + 1])
                    if chain is not None:
                        _integ.fold_shard_device_digests(chain, got.dig)
                    newc = counts
                lvl_new_per_shard += newc
                lvl_recv_per_shard += counts
                shard_visited += newc
                if obs_.collect:
                    lvl_act_en += got.act_en.sum(axis=0)
                    lvl_en_per_shard += got.act_en.sum(axis=1)
                for d in range(D):
                    offs[d] = min(nc * B, lens[d])

            if sdev is not None and sdev.fallback is None:
                governor.poll(depth)  # the deadline watchdog
                run_device_level()

            staged = None
            while verdict is None:
                ctx = build_chunk()
                if ctx is None:
                    break
                cur = (ctx, dispatch(ctx))
                if stage_chunks:
                    staged_peak = max(staged_peak, 2 if staged is not None else 1)
                    if staged is not None and commit(*staged):
                        staged = None
                        break
                    staged = cur
                elif commit(*cur):
                    break
            if staged is not None and verdict is None:
                commit(*staged)

            if verdict is not None:
                inv_name, d, row, gidx = verdict
                violation = build_violation(inv_name, depth, gidx) or Violation(
                    invariant=inv_name, depth=depth, state=decode_row(pending[d][row]),
                    trace=[])
                break

            n_new = int(lvl_new_per_shard.sum())
            exch_bytes_total += lvl_exch_bytes
            exch_raw_bytes_total += lvl_exch_raw_bytes
            depth += 1
            if n_new:
                levels.append(n_new)
                total += n_new
            if chain is not None:
                if n_new:
                    chain.seal(depth, n_new)
                else:
                    chain.reset_fold()
            if obs_.collect and is_coordinator():
                enabled_total = int(lvl_act_en.sum())
                shard_extra = {}
                if visited_backend == "host":
                    shard_extra["shard_duplicates"] = (lvl_recv_per_shard
                                                       - lvl_new_per_shard).tolist()
                rec = obs_.level(
                    depth=depth,
                    frontier=int(prev_base[-1]),
                    enabled_candidates=enabled_total,
                    new=n_new,
                    duplicates=enabled_total - n_new,
                    total=total,
                    level_ms=round((time.perf_counter() - t_level) * 1e3, 1),
                    shard_new=lvl_new_per_shard.tolist(),
                    shard_frontier=np.diff(prev_base).astype(np.int64).tolist(),
                    shard_enabled=lvl_en_per_shard.tolist(),
                    **shard_extra,
                    action_enablement={a.name: int(c)
                                       for a, c in zip(model.actions, lvl_act_en.tolist())},
                )
                # in memory only, as in the JAX package: the exchange bytes
                # (at the port's widths), the per-shard launches and the
                # overlap layer's hidden and exposed I/O
                busy1, blk1 = worker_counters(workers)
                result_levels.append({
                    **rec,
                    "exch_bytes": int(lvl_exch_bytes),
                    "exch_raw_bytes": int(lvl_exch_raw_bytes),
                    "shard_launches": int(lvl_dispatches),
                    **({"host_probe_ms": round(lvl_probe_ms, 2)} if lvl_probe_ms else {}),
                    "io_hidden_ms": round(max(0.0, (busy1 - lvl_io0[0])
                                              - (blk1 - lvl_io0[1])) * 1e3, 2),
                    "io_exposed_ms": round((blk1 - lvl_io0[1]) * 1e3, 2),
                })
                _met.set_gauge("kspec_shard_launches_level", int(lvl_dispatches))
                if lvl_probe_ms:
                    _met.set_gauge("kspec_host_probe_ms", round(lvl_probe_ms, 2))
                if lvl_exch_raw_bytes:
                    _met.set_gauge("kspec_exchange_bytes_level", int(lvl_exch_bytes))
                    _met.set_gauge("kspec_exchange_compression_ratio",
                                   round(lvl_exch_raw_bytes / max(lvl_exch_bytes, 1), 3))
            if progress:
                progress(depth, n_new, total)
            shard_beat(depth, new=n_new, total=total)
            pending = [torch.cat(next_pending[d]) if next_pending[d]
                       else torch.zeros((0, K), dtype=torch.int64, device=home)
                       for d in range(D)]
            parents = [torch.cat(x) if x else torch.zeros(0, dtype=torch.int64, device=home)
                       for x in next_parent]
            acts = [torch.cat(x) if x else torch.zeros(0, dtype=torch.int64, device=home)
                    for x in next_act]
            if plog is not None:
                # the level's segments before the checkpoint: a checkpoint at
                # depth R implies the log resolves every level <= R
                plog.write_level(depth, [to_u32(p).reshape(-1, K) for p in pending],
                                 [x.cpu().numpy() for x in parents],
                                 [x.cpu().numpy() for x in acts])
            if ckpt_store is not None and depth % checkpoint_every == 0:
                save_checkpoint()
                last_ckpt_depth = depth
            if store_trace:
                trace_store.append((torch.cat(pending), torch.cat(parents), torch.cat(acts)))
            # the level boundary's governance: pressure, an injected stall,
            # a soft breach's reclaim, a hard breach's typed exit.  With
            # several processes there is no reclaim or save hook: both reach
            # collectives, and a breach can be one process's own, so a lone
            # breacher exits typed from the last lockstep checkpoint
            multi = is_multiprocess()
            governor.level_end(depth, reclaim=None if multi else reclaim,
                               save_hook=None if multi else final_save)
        # the async tail inside the typed-error scope: a pending save's
        # ENOSPC or a background merge's fault maps to the same exits
        ckpt_poll(block=True)
        for s in owned_tiers():
            s.quiesce()
    except ResourceExhausted as e:
        exhausted = e
    except IntegrityError as e:
        integrity_fail = e
    except (RunCorrupt, ParentLogCorrupt) as e:
        # a storage read failed its checksum (a spill run, a parent-log
        # segment): silent on-disk corruption caught where it is read
        integrity_fail = IntegrityError("storage", str(e), depth=depth)
    except OSError as e:
        if not is_disk_full(e):
            raise
        # ENOSPC from a checkpoint, spill or parent-log writer: every
        # writer cleaned up its tmp, so the promoted state is intact
        exhausted = ResourceExhausted("enospc", str(e), depth=depth)
    if integrity_fail is not None:
        try:
            _integ.record_violation(integrity_fail)
            shard_beat(depth, event="integrity-violation", site=integrity_fail.site,
                       detail=integrity_fail.detail[:200])
            obs_.abort("integrity-violation", site=integrity_fail.site,
                       depth=integrity_fail.depth, detail=integrity_fail.detail[:300],
                       distinct_states=total)
            obs_.close()
        except OSError:
            pass
        raise integrity_fail
    if exhausted is not None:
        try:
            shard_beat(depth, event="resource-exhausted", reason=exhausted.reason,
                       detail=exhausted.detail[:200])
            obs_.abort("resource-exhausted", reason=exhausted.reason, depth=exhausted.depth,
                       detail=exhausted.detail, distinct_states=total, **governor.stats())
            obs_.close()
        except OSError:
            pass
        raise exhausted

    if violation is None and cut and model.invariants:
        # the cut left the last frontier unexpanded: its invariant pass, in
        # shard-major order (the trace store's level layout)
        rows = torch.cat(pending)
        if rows.shape[0]:
            st = spec.unpack(rows)
            for inv in model.invariants:
                ok = inv.pred(st)
                if not bool(ok.all()):
                    idx = int(torch.argmax((~ok).to(torch.uint8)))
                    violation = build_violation(inv.name, depth, idx) or Violation(
                        invariant=inv.name, depth=depth, state=decode_row(rows[idx]), trace=[])
                    break

    if home.type == "cuda":
        torch.cuda.synchronize(home)
    dt = time.perf_counter() - t0
    close_workers(workers, drain=True)
    shard_beat(depth, event="finish", ok=violation is None)
    stats = {
        "devices": D,
        **({"levels": result_levels} if result_levels else {}),
        "visited_capacity_per_shard": int(sets.cap),
        "fanout": C,
        "visited_backend": visited_backend,
        "exchange": exchange,
        "pipeline": pipe_name,
        "mesh_layouts": mesh_layouts(mesh),
        **({"device": {"levels": sdev.levels, "fallback": sdev.fallback}}
           if sdev is not None else {}),
        "adaptive_active": False,
        "adaptive_compile_fallback": False,
        "transient_retries": chunk_retry.retries_total,
        "degradations": chunk_retry.degradations,
        "overlap": {
            "enabled": overlap_on,
            "staged_chunks_peak": staged_peak,
            **({"io_worker": io_worker.stats()} if io_worker is not None else {}),
            **({"ckpt_worker": ckpt_worker.stats()} if ckpt_worker is not None else {}),
        },
        "exchange_compressed": compress_on,
        "exchange_bytes_total": int(exch_bytes_total),
        "exchange_raw_bytes_total": int(exch_raw_bytes_total),
    }
    if visited_backend == "host":
        stats["host_fpset_sizes"] = [len(s) if s is not None else None for s in sets.host]
    if visited_backend == "device-hash":
        stats["shard_visited"] = shard_visited.tolist()
    if use_disk:
        stats["spill"] = [s.stats() if s is not None else None for s in sets.host]
        stats["spill_dir"] = spill_base
    if ephemeral_spill is not None:
        shutil.rmtree(ephemeral_spill, ignore_errors=True)
    res = CheckResult(
        model=model.name,
        levels=levels,
        total=total,
        diameter=len(levels) - 1,
        violation=violation,
        seconds=dt,
        states_per_sec=total / max(dt, 1e-9),
        stats=stats,
    )
    obs_.finish(res)
    obs_.close()
    return res
