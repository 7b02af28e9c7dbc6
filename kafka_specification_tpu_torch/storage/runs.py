"""Sorted fingerprint runs: the on-disk level of the tiered visited set.

The port's own copy of ``kafka_specification_tpu/storage/runs.py``; the
run file format is the same byte for byte.

A run is an immutable file of strictly increasing uint64 fingerprints —
the LSM-ish shape TLC's DiskFPSet and BLEST's tiered visited set share:
writes are sequential (one sorted dump per spill), membership is a binary
search over an mmap that touches O(log n) pages, and compaction is a
bounded-memory k-way merge of immutable inputs into one new immutable
output (crash mid-merge leaves the inputs untouched).

File format: `KRUN1\\0` magic, u64 count, payload of count u64 LE values.
The content CRC + count + [lo, hi] interval live in the engine checkpoint's
manifest (storage/tiered.py), not in the file — the manifest is what makes
a run *referenced*; unreferenced files are orphans and are swept at open.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from .atomic import atomic_write
from .bloom import DEFAULT_BITS_PER_KEY, BloomFilter

_MAGIC = b"KRUN1\x00"
_HEADER = len(_MAGIC) + 8  # magic + u64 count


class RunCorrupt(Exception):
    """A run file failed its manifest (count/CRC) verification."""


def write_run(path: str, fps: np.ndarray, bloom_path=None,
              before_replace=None) -> dict:
    """Atomically write sorted fingerprints `fps` as a run; -> manifest
    entry {name, count, crc32, lo, hi}.  `fps` must already be sorted and
    duplicate-free (the tiered set guarantees disjoint spills).
    `before_replace` is the pre-promote fault-injection point
    (`KSPEC_FAULT=enospc@spill:N`)."""
    fps = np.ascontiguousarray(fps, np.uint64)
    payload = fps.tobytes()

    def write(fh):
        fh.write(_MAGIC)
        fh.write(np.uint64(fps.shape[0]).tobytes())
        fh.write(payload)

    atomic_write(path, write, before_replace=before_replace)
    if bloom_path is not None:
        BloomFilter.build(fps).save(bloom_path)
    return {
        "name": os.path.basename(path),
        "count": int(fps.shape[0]),
        "crc32": zlib.crc32(payload),
        "lo": int(fps[0]) if fps.shape[0] else 0,
        "hi": int(fps[-1]) if fps.shape[0] else 0,
    }


class SortedRun:
    """An open run: mmap'd values + interval + bloom gate."""

    def __init__(self, directory: str, meta: dict, verify: bool = True):
        self.meta = meta
        self.path = os.path.join(directory, meta["name"])
        self.count = int(meta["count"])
        self.lo = np.uint64(meta["lo"])
        self.hi = np.uint64(meta["hi"])
        if not os.path.exists(self.path):
            raise RunCorrupt(f"{self.path}: missing run file")
        size = os.path.getsize(self.path)
        if size != _HEADER + 8 * self.count:
            raise RunCorrupt(
                f"{self.path}: size {size} != header + 8*{self.count}"
            )
        self.arr = np.memmap(
            self.path, dtype=np.uint64, mode="r", offset=_HEADER,
            shape=(self.count,),
        )
        # verify=False (a run this process just wrote) defers the content
        # CRC to the FIRST lookup instead of skipping it: reads verify,
        # not just writes — a bit flipped on disk between the atomic
        # promote and the first probe (resilience.integrity's flip@spill
        # rehearsal, or real bit rot under a long-lived run) is caught at
        # consumption time, before a wrong membership answer can corrupt
        # the search
        self._read_verified = False
        if verify:
            self._verify_content()
        bloom_path = self.path + ".bloom"
        self.bloom = BloomFilter.load(bloom_path)
        if self.bloom is None:  # missing/rotted sidecar: rebuild, re-save
            self.bloom = BloomFilter.build(np.asarray(self.arr))
            self.bloom.save(bloom_path)
        # bloom-gate accounting (stats["spill"]: how much disk traffic the
        # per-run gates actually save on a spilled run)
        self.probes = 0  # interval-passing queries
        self.bloom_maybe = 0  # of those, bloom said "maybe" (disk touched)
        self.hits = 0  # of those, actually present

    def _verify_content(self) -> None:
        if zlib.crc32(self.arr.tobytes()) != int(self.meta["crc32"]):
            raise RunCorrupt(f"{self.path}: content CRC mismatch")
        self._read_verified = True

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """Exact membership mask for a (possibly unsorted) query batch."""
        out = np.zeros(fps.shape[0], bool)
        if not self.count:
            return out
        if not self._read_verified:
            # read-side integrity: one full-content CRC at first lookup
            # (unconditional — the bloom/interval gates must not be able
            # to defer detection indefinitely), then mmap reads as usual
            self._verify_content()
        cand = (fps >= self.lo) & (fps <= self.hi)
        if not cand.any():
            return out
        ci = np.nonzero(cand)[0]
        q = fps[ci]
        self.probes += int(ci.shape[0])
        m = self.bloom.maybe(q)  # the disk-touch gate
        self.bloom_maybe += int(m.sum())
        if not m.any():
            return out
        ci, q = ci[m], q[m]
        pos = np.searchsorted(self.arr, q)
        hit = self.arr[np.minimum(pos, self.count - 1)] == q
        self.hits += int(hit.sum())
        out[ci[hit]] = True
        return out


def merge_runs(runs: list, out_path: str, block: int = 1 << 20,
               crash_hook=None) -> dict:
    """Bounded-memory k-way merge of open `SortedRun`s into one new run.

    Per iteration, each live cursor contributes up to `block` values; the
    emit bound is the smallest block-tail across live runs, so everything
    emitted is globally final (all remaining values exceed it).  Inputs
    are disjoint by construction (a fingerprint is spilled exactly once),
    so no dedup pass is needed.  `crash_hook` runs after the tmp write,
    before the atomic promote — the mid-merge torn-write injection point
    (`KSPEC_FAULT=crash@merge:N`).  -> the merged run's manifest entry.
    """
    # every input must pass its content CRC BEFORE its values are
    # streamed: merging an as-yet-unverified corrupt run would launder
    # the corruption into a merged run with a fresh VALID checksum,
    # defeating the read-side verification contract permanently
    for r in runs:
        if not r._read_verified:
            r._verify_content()
    cursors = [0] * len(runs)
    state = {"crc": 0, "total": 0, "lo": None, "hi": None}
    # the filter's bit count is fixed at build time — size it for the final
    # merged count up front, then add each emitted block incrementally
    n_total = sum(r.count for r in runs)
    bloom = BloomFilter(
        np.zeros(_next_pow2_bytes(DEFAULT_BITS_PER_KEY * n_total), np.uint8)
    )

    def write(fh):
        fh.write(_MAGIC)
        fh.write(np.uint64(0).tobytes())  # count patched below
        while True:
            bound = None
            for i, r in enumerate(runs):
                if cursors[i] < r.count:
                    tail = r.arr[min(cursors[i] + block, r.count) - 1]
                    bound = tail if bound is None else min(bound, tail)
            if bound is None:
                break
            parts = []
            for i, r in enumerate(runs):
                if cursors[i] >= r.count:
                    continue
                end = min(cursors[i] + block, r.count)
                seg = np.asarray(r.arr[cursors[i]:end])
                take = int(np.searchsorted(seg, bound, side="right"))
                if take:
                    parts.append(seg[:take])
                    cursors[i] += take
            merged = np.sort(np.concatenate(parts))
            payload = merged.tobytes()
            state["crc"] = zlib.crc32(payload, state["crc"])
            fh.write(payload)
            bloom.add(merged)
            state["total"] += merged.shape[0]
            if state["lo"] is None:
                state["lo"] = int(merged[0])
            state["hi"] = int(merged[-1])
        fh.seek(len(_MAGIC))
        fh.write(np.uint64(state["total"]).tobytes())

    atomic_write(out_path, write, before_replace=crash_hook)
    bloom.save(out_path + ".bloom")
    return {
        "name": os.path.basename(out_path),
        "count": state["total"],
        "crc32": state["crc"],
        "lo": state["lo"] or 0,
        "hi": state["hi"] or 0,
    }


def _next_pow2_bytes(nbits: int) -> int:
    nbits = max(1 << 13, nbits)
    return (1 << max(0, (nbits - 1).bit_length())) // 8
