"""PyTorch port: the compressed exchange's codec (ops/fpcompress.py)
against the JAX package's, bit for bit: the packed words, the headers and
the overflow flags of ``pack_sorted`` equal JAX's jitted ``pack_sorted``
and the numpy twin ``pack_np`` on the same buckets, and ``unpack_sorted``
gives back the lanes (and JAX's lanes on an overflowed stream, whose
words are incomplete).  The port packs a [D, W] batch of buckets in one
call, as the sharded engine does; its numpy twins are the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_specification_tpu.ops import fpcompress as jfpc
from kafka_specification_tpu_torch.ops import fpcompress as fpc

pytestmark = pytest.mark.overlap

SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def lanes(vals: np.ndarray, W: int):
    """Sorted u64 values padded with sentinels to W -> (hi, lo) u32."""
    full = np.concatenate([vals, np.full(W - vals.shape[0], SENT64)])
    return (full >> np.uint64(32)).astype(np.uint32), (full & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


_JIT: dict = {}


def jitted(kind, *static):
    """JAX's pack (vmapped over buckets) or unpack, compiled once per
    static width for the whole module."""
    key = (kind,) + static
    if key not in _JIT:
        if kind == "pack":
            NW, = static
            _JIT[key] = jax.jit(jax.vmap(lambda a, b, c: jfpc.pack_sorted(a, b, c, NW)))
        else:
            W, = static
            _JIT[key] = jax.jit(jax.vmap(lambda a, b: jfpc.unpack_sorted(a, b, W)))
    return _JIT[key]


def jax_pack(hi, lo, n, NW):
    """JAX's pack of one bucket, or of a [D, W] batch (`n` then [D])."""
    one = np.ndim(hi) == 1
    w, h, o = jitted("pack", NW)(jnp.asarray(np.atleast_2d(hi)), jnp.asarray(np.atleast_2d(lo)),
                                 jnp.asarray(np.atleast_1d(n), jnp.int32))
    w, h, o = np.asarray(w), np.asarray(h), np.asarray(o)
    return (w[0], h[0], bool(o[0])) if one else (w, h, o)


def test_fpcompress_roundtrip_jit_matches_numpy():
    """JAX's round-trip cases: the port's words and header are JAX's and
    pack_np's, nothing overflows at the default budget, both unpacks give
    the lanes back, and the packed bucket is smaller than the raw one."""
    rng = np.random.default_rng(7)
    for W, n in [(64, 0), (64, 17), (128, 1), (128, 60), (256, 100), (512, 200)]:
        vals = np.sort(rng.integers(0, 2**64 - 2, size=n, dtype=np.uint64))
        if n > 3:
            vals[2] = vals[1]  # duplicate fingerprints must survive
            vals = np.sort(vals)
        hi, lo = lanes(vals, W)
        NW = fpc.default_stream_words(W)
        words, hdr, ovf = fpc.pack_sorted(t64(hi), t64(lo), n, NW)
        words, hdr, ovf = words.numpy(), hdr.numpy(), bool(ovf)
        jw, jh, jo = jax_pack(hi, lo, n, NW)
        wn, hn, on = fpc.pack_np(hi, lo, n, NW)
        assert np.array_equal(words, jw) and np.array_equal(hdr, jh) and ovf == jo
        assert np.array_equal(words, wn) and np.array_equal(hdr, hn) and ovf == on
        assert not ovf, (W, n)
        h2, l2 = fpc.unpack_sorted(t64(words), t64(hdr), W)
        assert np.array_equal(h2.numpy(), hi) and np.array_equal(l2.numpy(), lo)
        h3, l3 = fpc.unpack_np(words, hdr, W)
        assert np.array_equal(h3, hi) and np.array_equal(l3, lo)
        assert fpc.packed_bytes(W, NW) < fpc.raw_bytes(W)


def test_fpcompress_overflow_flag_on_dense_bucket():
    """A full bucket of random fingerprints cannot fit one word a slot:
    both packs flag it, with JAX's (truncated) words."""
    rng = np.random.default_rng(3)
    W = 128
    vals = np.sort(rng.integers(0, 2**64 - 2, size=W, dtype=np.uint64))
    hi, lo = lanes(vals, W)
    NW = fpc.default_stream_words(W)
    _w, _h, ovf = fpc.pack_np(hi, lo, W, NW)
    assert ovf
    words, hdr, tovf = fpc.pack_sorted(t64(hi), t64(lo), W, NW)
    jw, jh, jo = jax_pack(hi, lo, W, NW)
    assert bool(tovf) and jo
    assert np.array_equal(words.numpy(), jw) and np.array_equal(hdr.numpy(), jh)
    assert np.array_equal(words.numpy(), _w)


def test_constants_and_sizes_equal_jax():
    assert (fpc.BLK, fpc.HDR) == (jfpc.BLK, jfpc.HDR)
    for W in (1, 31, 32, 33, 64, 100, 1000, 4096):
        assert fpc.n_blocks(W) == jfpc.n_blocks(W)
        assert fpc.header_words(W) == jfpc.header_words(W)
        assert fpc.default_stream_words(W) == jfpc.default_stream_words(W)
        assert fpc.packed_bytes(W, W) == jfpc.packed_bytes(W, W)
        assert fpc.raw_bytes(W) == jfpc.raw_bytes(W)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_buckets_batched_equal_jax_and_numpy(seed):
    """D buckets drawn from a numpy seed (empty, sparse, half full, dense,
    clustered values, a run of duplicates, widths off the block size),
    packed in ONE batched call as the sharded engine packs them: every
    bucket's words, header and flag are JAX's and pack_np's, at the default
    budget and at a starved one; the batched unpack is JAX's unpack."""
    rng = np.random.default_rng(seed)
    for W in (32, 96, 200):
        D = 8
        counts = rng.integers(0, W + 1, size=D)
        counts[:3] = (0, W // 2, W)
        rows = []
        for d in range(D):
            n = int(counts[d])
            if d == 3:
                base = rng.integers(0, 2**63, dtype=np.uint64)
                vals = base + rng.integers(0, 1 << 20, size=n).astype(np.uint64)
            elif d == 4 and n:
                vals = np.full(n, rng.integers(0, 2**64 - 2, dtype=np.uint64))
            else:
                vals = rng.integers(0, 2**64 - 2, size=n, dtype=np.uint64)
            rows.append(lanes(np.sort(vals), W))
        hi = np.stack([r[0] for r in rows])
        lo = np.stack([r[1] for r in rows])
        for NW in (fpc.default_stream_words(W), fpc.BLK):
            words, hdr, ovf = fpc.pack_sorted(t64(hi), t64(lo), t64(counts), NW)
            jw, jh, jo = jax_pack(hi, lo, counts, NW)
            assert np.array_equal(words.numpy(), jw) and np.array_equal(hdr.numpy(), jh)
            assert np.array_equal(ovf.numpy(), jo)
            for d in range(D):
                wn, hn, on = fpc.pack_np(hi[d], lo[d], int(counts[d]), NW)
                assert np.array_equal(words[d].numpy(), wn) and np.array_equal(hdr[d].numpy(), hn)
                assert bool(ovf[d]) == on
                if not on:
                    assert np.array_equal(fpc.unpack_np(wn, hn, W)[0], hi[d])
            ju, jl = jitted("unpack", W)(jnp.asarray(jw), jnp.asarray(jh))
            h2, l2 = fpc.unpack_sorted(words, hdr, W)
            assert np.array_equal(h2.numpy(), np.asarray(ju)) and np.array_equal(
                l2.numpy(), np.asarray(jl))
            ok = ~ovf.numpy()
            assert np.array_equal(h2.numpy()[ok], hi[ok]) and np.array_equal(l2.numpy()[ok],
                                                                            lo[ok])


def test_int32_wire_round_trip_is_exact():
    """The engine sends words and headers as int32 (gloo refuses uint32);
    the receiver's mask gives back every u32 value."""
    rng = np.random.default_rng(11)
    vals = np.sort(rng.integers(0, 2**64 - 2, size=40, dtype=np.uint64))
    hi, lo = lanes(vals, 128)
    words, hdr, ovf = fpc.pack_sorted(t64(hi), t64(lo), 40, fpc.default_stream_words(128))
    assert not bool(ovf) and int(words.max()) >= 1 << 31
    back = words.to(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(back, words)
    h2, l2 = fpc.unpack_sorted(back, hdr.to(torch.int32).to(torch.int64) & 0xFFFFFFFF, 128)
    assert np.array_equal(h2.numpy(), hi) and np.array_equal(l2.numpy(), lo)
