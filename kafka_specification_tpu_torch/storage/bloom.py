"""Bloom filter over 64-bit fingerprints (the disk tier's lookup gate).

The port's own copy of ``kafka_specification_tpu/storage/bloom.py``; the
sidecar file format is the same byte for byte.

One filter per sorted run keeps negative membership queries off disk: a
miss in every run's filter means the fingerprint is definitely not in the
visited set, so only *probable* hits pay a binary search through the
mmap'd run.  At the default 16 bits/key with k=2 probes the false-positive
rate is ~1.5% — i.e. >98% of novel-fingerprint lookups never touch a run.

Correctness note: a bloom false POSITIVE only costs a wasted searchsorted;
a false NEGATIVE would mis-classify a visited state as new and corrupt the
search.  False negatives are impossible for a filter built from the run it
guards — which is why the sidecar file carries a CRC and a corrupt or
missing sidecar triggers a rebuild from the run instead of being trusted.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from .atomic import atomic_write

# bits of bloom per fingerprint (RAM residency ~bits/8 B per DISK
# fingerprint); 16 -> ~1.5%
# false-positive at k=2.  Env-tunable: at the multi-billion scale the
# filters themselves are gigabytes, and halving the density doubles only
# the *wasted-searchsorted* rate, never correctness.
DEFAULT_BITS_PER_KEY = int(os.environ.get("KSPEC_SPILL_BLOOM_BITS", "16"))

_MAGIC = b"KBLM1\x00"
# splitmix64 finalizer constants — decorrelates the probe positions from
# the fingerprint bits (fingerprints are themselves hashes, but exact64
# mode packs raw state lanes whose low bits are highly structured)
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= _C1
    x ^= x >> np.uint64(27)
    x *= _C2
    x ^= x >> np.uint64(31)
    return x


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class BloomFilter:
    """k=2 blocked-free bloom filter with a power-of-two bit count."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits  # uint8 byte array, len a power of two
        self.nbits = bits.shape[0] * 8
        self._mask = np.uint64(self.nbits - 1)

    @classmethod
    def build(cls, fps: np.ndarray, bits_per_key=None) -> "BloomFilter":
        if bits_per_key is None:
            bits_per_key = DEFAULT_BITS_PER_KEY
        nbits = _next_pow2(max(1 << 13, bits_per_key * int(fps.shape[0])))
        bf = cls(np.zeros(nbits // 8, np.uint8))
        bf.add(fps)
        return bf

    def _positions(self, fps: np.ndarray):
        h = _mix(fps)
        return h & self._mask, (h >> np.uint64(17)) & self._mask

    def add(self, fps: np.ndarray) -> None:
        for pos in self._positions(fps):
            np.bitwise_or.at(
                self.bits, (pos >> np.uint64(3)).astype(np.int64),
                np.left_shift(np.uint8(1), (pos & np.uint64(7)).astype(np.uint8)),
            )

    def maybe(self, fps: np.ndarray) -> np.ndarray:
        """bool mask: False = definitely absent, True = probably present."""
        out = np.ones(fps.shape[0], bool)
        for pos in self._positions(fps):
            byte = self.bits[(pos >> np.uint64(3)).astype(np.int64)]
            out &= (byte >> (pos & np.uint64(7)).astype(np.uint8)) & 1 != 0
        return out

    # --- sidecar persistence (missing/corrupt -> caller rebuilds) -------
    def save(self, path: str) -> None:
        def write(fh):
            fh.write(_MAGIC)
            fh.write(np.uint64(self.nbits).tobytes())
            fh.write(np.uint32(zlib.crc32(self.bits.tobytes())).tobytes())
            fh.write(self.bits.tobytes())

        atomic_write(path, write)

    @classmethod
    def load(cls, path: str):
        """The filter, or None when the sidecar is missing/corrupt (a
        false negative from trusting a rotted filter would corrupt the
        search — rebuild instead)."""
        try:
            with open(path, "rb") as fh:
                if fh.read(len(_MAGIC)) != _MAGIC:
                    return None
                nbits = int(np.frombuffer(fh.read(8), np.uint64)[0])
                crc = int(np.frombuffer(fh.read(4), np.uint32)[0])
                bits = np.frombuffer(fh.read(nbits // 8), np.uint8).copy()
        except (OSError, ValueError, IndexError):
            return None
        if bits.shape[0] != nbits // 8 or zlib.crc32(bits.tobytes()) != crc:
            return None
        return cls(bits)
