"""Bit-packed delta codec for sorted fingerprint exchange payloads (PyTorch).

Counterpart of ``kafka_specification_tpu/ops/fpcompress.py``, the
compressed wire format of the sharded engine's ``all_to_all``
(``parallel/sharded.py``):

- each destination bucket is **sorted** (stable, sentinels last: the
  property that keeps the dedup winners bit-identical), so its live
  prefix is an ascending u64 sequence;
- the live values are **delta-encoded** from a per-bucket base (the first
  value rides the header); the deltas of the padding tail are zero, by the
  bucket's live count (also in the header);
- deltas are **bit-packed** in blocks of :data:`BLK` values, each block at
  the bit width of its largest delta, into an ``n_words``-word u32 stream.
  A stream too small for its bucket raises the overflow flag (the words
  past the stream are dropped, as the JAX package's ``mode="drop"``
  scatter drops them).

The JAX codec is XLA, not Pallas, so these are tensor operations on the
shard's device, as ``ops/devlevel.py`` is.  torch has no uint64: a 64-bit
value is a (hi, lo) pair of u32 values held in int64 tensors, with
explicit borrows and carries, and every u32 result is masked to 32 bits.
``pack_sorted`` / ``unpack_sorted`` take any leading batch dimensions (the
engine packs its D buckets in one call); their words, headers and
overflow flags are the JAX functions' bit for bit on the same buckets.
``pack_np`` / ``unpack_np`` are the numpy twins, copied from the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

#: values per bit-packing block (one shared bit width per block)
BLK = 32
#: header layout: [count, first_hi, first_lo] + one bit width per block
HDR = 3

_SENT = 0xFFFFFFFF
_M32 = 0xFFFFFFFF


def n_blocks(width: int) -> int:
    return -(-int(width) // BLK)


def header_words(width: int) -> int:
    return HDR + n_blocks(width)


def default_stream_words(width: int) -> int:
    """Default packed-stream budget: one u32 word per slot, half the raw
    fingerprint lanes' two.  A bucket whose live deltas need more bits
    overflows; the engine then widens the bucket (or, at full width, sends
    the chunk raw)."""
    return max(BLK, int(width))


def _nbits32(x: torch.Tensor) -> torch.Tensor:
    """Bit length of u32 values (0 -> 0)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >> s
        take = big > 0
        x = torch.where(take, big, x)
        n = n + take.to(n.dtype) * s
    return n + (x > 0).to(n.dtype)


def _low_mask(bits: torch.Tensor) -> torch.Tensor:
    """2^bits - 1 for bits in [0, 32]."""
    one = torch.ones_like(bits)
    return torch.where(bits >= 32, torch.full_like(bits, _M32),
                       (one << bits.clamp(max=31)) - one)


def _block_layout(bwb: torch.Tensor, Wp: int):
    """Per value of a bucket padded to Wp slots: (its bit width, its bit
    position in the stream), from the per-block widths [..., NB]."""
    blk_bits = bwb * BLK
    blk_off = torch.cumsum(blk_bits, -1) - blk_bits
    idx = torch.arange(Wp, device=bwb.device)
    b = idx // BLK
    bw = bwb[..., b]
    return bw, blk_off[..., b] + (idx % BLK) * bw


def pack_sorted(hi: torch.Tensor, lo: torch.Tensor, count, n_words: int):
    """Pack sorted buckets' fingerprint lanes -> (words, header, ovf).

    hi/lo: [..., W] u32 values (int64 tensors), each bucket ascending as
    u64 with its sentinel padding last; count: live values per bucket (an
    int or a [...] tensor).  Returns the packed u32 streams [..., n_words],
    the headers [..., HDR + n_blocks(W)] (count, first value, per-block
    bit widths) and the overflow flags [...] (a stream too small for its
    bucket: its words are then incomplete)."""
    W = hi.shape[-1]
    NB = n_blocks(W)
    Wp = NB * BLK
    lead = hi.shape[:-1]
    dev = hi.device
    count = torch.as_tensor(count, dtype=torch.int64, device=dev).expand(lead).clamp(max=W)
    if Wp > W:
        pad = torch.full(lead + (Wp - W,), _SENT, dtype=torch.int64, device=dev)
        hi, lo = torch.cat([hi, pad], -1), torch.cat([lo, pad], -1)
    idx = torch.arange(Wp, device=dev)
    live = idx < count[..., None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    first_hi = torch.where(count > 0, hi[..., 0], zero)
    first_lo = torch.where(count > 0, lo[..., 0], zero)
    # the two-limb delta v[i] - v[i-1] (ascending: non-negative); index 0
    # deltas from the header's base, the padding's deltas are 0
    ph = torch.cat([first_hi[..., None], hi[..., :-1]], -1)
    pl = torch.cat([first_lo[..., None], lo[..., :-1]], -1)
    dlo = (lo - pl) & _M32
    dhi = (hi - ph - (lo < pl).to(torch.int64)) & _M32
    dhi = torch.where(live, dhi, zero)
    dlo = torch.where(live, dlo, zero)
    bw = torch.where(dhi > 0, 32 + _nbits32(dhi), _nbits32(dlo))
    bwb = bw.reshape(lead + (NB, BLK)).amax(-1)
    ovf = (bwb * BLK).sum(-1) > n_words * 32
    _bw, pos = _block_layout(bwb, Wp)
    w = pos // 32
    sh = pos % 32
    sh32 = (32 - sh) & 31
    nz = sh > 0
    # a value spans <= 3 words and owns bits [pos, pos + bw): the
    # contributions never overlap, so adding them is OR-ing them
    c0 = (dlo << sh) & _M32
    c1 = torch.where(nz, (dlo >> sh32) | ((dhi << sh) & _M32), dhi)
    c2 = torch.where(nz, dhi >> sh32, zero)
    # one slot past the stream takes every word index the stream has not
    # (the JAX package's out-of-range scatter drops them)
    words = torch.zeros(lead + (n_words + 1,), dtype=torch.int64, device=dev)
    for k, c in enumerate((c0, c1, c2)):
        words.scatter_add_(-1, (w + k).clamp(max=n_words), c)
    header = torch.cat([count[..., None], first_hi[..., None], first_lo[..., None], bwb], -1)
    return words[..., :n_words], header, ovf


def unpack_sorted(words: torch.Tensor, header: torch.Tensor, width: int):
    """Inverse of :func:`pack_sorted` -> (hi, lo) [..., width] u32 values
    (int64 tensors) with the sentinel tail restored."""
    NB = n_blocks(width)
    Wp = NB * BLK
    lead = words.shape[:-1]
    dev = words.device
    count = header[..., 0]
    first_hi = header[..., 1:2]
    first_lo = header[..., 2:3]
    bw, pos = _block_layout(header[..., HDR : HDR + NB], Wp)
    w = pos // 32
    sh = pos % 32
    sh32 = (32 - sh) & 31
    nz = sh > 0
    wpad = torch.cat([words, torch.zeros(lead + (4,), dtype=torch.int64, device=dev)], -1)
    last = wpad.shape[-1] - 1
    # an index past the buffer reads its last word, as a JAX gather clamps
    w0, w1, w2 = (wpad.gather(-1, (w + k).clamp(max=last)) for k in range(3))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    vlo = (w0 >> sh) | torch.where(nz, (w1 << sh32) & _M32, zero)
    vhi = torch.where(nz, (w1 >> sh) | ((w2 << sh32) & _M32), w1)
    dlo = vlo & _low_mask(bw.clamp(max=32))
    dhi = vhi & _low_mask((bw - 32).clamp(min=0))
    # the running 64-bit sum of the deltas, limb by limb (each limb's sum
    # is exact in int64), then re-based on the header's first value
    cs_lo = torch.cumsum(dlo, -1)
    slo = cs_lo & _M32
    shi = (torch.cumsum(dhi, -1) + (cs_lo >> 32)) & _M32
    lo = (slo + first_lo) & _M32
    hi = (shi + first_hi + (lo < first_lo).to(torch.int64)) & _M32
    live = torch.arange(Wp, device=dev) < count[..., None]
    sent = torch.full((), _SENT, dtype=torch.int64, device=dev)
    return (torch.where(live, hi, sent)[..., :width], torch.where(live, lo, sent)[..., :width])


def packed_bytes(width: int, n_words: int) -> int:
    """Wire bytes of one packed bucket (stream + header)."""
    return 4 * (int(n_words) + header_words(width))


def raw_bytes(width: int) -> int:
    """Wire bytes of one raw bucket's fingerprint lanes (hi + lo)."""
    return 8 * int(width)


# --- numpy twins -------------------------------------------------------------


def pack_np(hi, lo, count, n_words: int):
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    W = hi.shape[0]
    NB = n_blocks(W)
    Wp = NB * BLK
    count = int(min(count, W))
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    v = np.concatenate([v, np.full(Wp - W, np.uint64(0xFFFFFFFFFFFFFFFF))])
    first = v[0] if count > 0 else np.uint64(0)
    d = np.zeros(Wp, np.uint64)
    if count > 0:
        d[1:count] = v[1:count] - v[:count - 1]
    bw = np.array([int(x).bit_length() for x in d], np.int64)
    bwb = bw.reshape(NB, BLK).max(axis=1)
    blk_off = np.concatenate([[0], np.cumsum(bwb * BLK)[:-1]])
    total_bits = int((bwb * BLK).sum())
    ovf = total_bits > n_words * 32
    stream = 0
    for i in range(Wp):
        b = i // BLK
        if bwb[b] == 0:
            continue
        pos = int(blk_off[b] + (i % BLK) * bwb[b])
        stream |= int(d[i]) << pos
    words = np.zeros(n_words, np.uint32)
    mask = (1 << 32) - 1
    for wI in range(n_words):
        words[wI] = (stream >> (32 * wI)) & mask
    header = np.concatenate([
        np.asarray([count, int(first >> np.uint64(32)), int(first & np.uint64(0xFFFFFFFF))],
                   np.uint32),
        bwb.astype(np.uint32),
    ])
    return words, header, bool(ovf)


def unpack_np(words, header, width: int):
    words = np.asarray(words, np.uint32)
    header = np.asarray(header, np.uint32)
    NB = n_blocks(width)
    count = int(header[0])
    first = (np.uint64(header[1]) << np.uint64(32)) | np.uint64(header[2])
    bwb = header[HDR:HDR + NB].astype(np.int64)
    blk_off = np.concatenate([[0], np.cumsum(bwb * BLK)[:-1]])
    stream = 0
    for wI in range(words.shape[0] - 1, -1, -1):
        stream = (stream << 32) | int(words[wI])
    out = np.full(width, np.uint64(0xFFFFFFFFFFFFFFFF))
    acc = int(first)
    for i in range(min(count, width)):
        b = i // BLK
        bwv = int(bwb[b])
        if bwv:
            pos = int(blk_off[b] + (i % BLK) * bwv)
            acc = (acc + ((stream >> pos) & ((1 << bwv) - 1))) & ((1 << 64) - 1)
        out[i] = np.uint64(acc)
    hi = (out >> np.uint64(32)).astype(np.uint32)
    lo = (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo
