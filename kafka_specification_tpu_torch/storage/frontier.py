"""Disk-spilled frontier queue: chunked segments in discovery order.

The port's own copy of ``kafka_specification_tpu/storage/frontier.py``,
writing the same files byte for byte.

A BFS level's next frontier can itself outgrow RAM (and the card: no
tensor holds a whole spilled level; the engine takes it chunk by chunk
through ``slice``/``iter_chunks``).  The writer appends novel rows in discovery order and
cuts an immutable segment file every `seg_rows`; the reader replays them
in the exact same order and chunk boundaries as the in-RAM path, so the
engine's per-chunk computation — and therefore every count and trace — is
bit-identical.

Segment format: `KFRN1\\0` magic, u64 rows, u32 lanes, payload of
rows x lanes u32 LE.  CRC + row counts live in the manifest the engine
checkpoint records ("frontier-segment offsets"); consumed levels'
segments are deleted behind the checkpoint deletion barrier.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from .atomic import atomic_write

_MAGIC = b"KFRN1\x00"
_HEADER = len(_MAGIC) + 8 + 4


class SegmentCorrupt(Exception):
    """A frontier segment failed its manifest verification."""


class FrontierWriter:
    def __init__(self, directory: str, level: int, lanes: int,
                 seg_rows: int = 1 << 18):
        self.dir = directory
        self.level = int(level)
        self.K = int(lanes)
        self.seg_rows = max(1, int(seg_rows))
        self.segments: list[dict] = []
        self._buf: list[np.ndarray] = []
        self._buf_rows = 0
        self.rows = 0
        os.makedirs(directory, exist_ok=True)

    def append(self, rows: np.ndarray) -> None:
        if rows.shape[0] == 0:
            return
        self._buf.append(np.ascontiguousarray(rows, np.uint32))
        self._buf_rows += rows.shape[0]
        self.rows += rows.shape[0]
        while self._buf_rows >= self.seg_rows:
            self._cut(self.seg_rows)

    def _cut(self, n: int) -> None:
        data = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
        seg, rest = data[:n], data[n:]
        self._buf = [rest] if rest.shape[0] else []
        self._buf_rows = rest.shape[0]
        name = f"frontier-L{self.level:05d}-{len(self.segments):05d}.seg"
        path = os.path.join(self.dir, name)
        payload = seg.tobytes()

        def write(fh):
            fh.write(_MAGIC)
            fh.write(np.uint64(seg.shape[0]).tobytes())
            fh.write(np.uint32(self.K).tobytes())
            fh.write(payload)

        atomic_write(path, write)
        self.segments.append(
            {"name": name, "rows": int(seg.shape[0]), "crc32": zlib.crc32(payload)}
        )

    def finalize(self) -> "FrontierReader":
        if self._buf_rows:
            self._cut(self._buf_rows)
        return FrontierReader(self.dir, self.manifest(), verify=False)

    def manifest(self) -> dict:
        return {
            "level": self.level,
            "lanes": self.K,
            "rows": self.rows,
            "segments": list(self.segments),
        }


class FrontierReader:
    """Replays a level's rows with the same global offsets and chunk
    boundaries the in-RAM `frontier_np[start:start+chunk]` loop produces."""

    def __init__(self, directory: str, manifest: dict, verify: bool = True):
        self.dir = directory
        self.man = manifest
        self.K = int(manifest["lanes"])
        self.rows = int(manifest["rows"])
        self.level = int(manifest["level"])
        self._starts = np.cumsum(
            [0] + [int(s["rows"]) for s in manifest["segments"]]
        )
        if int(self._starts[-1]) != self.rows:
            raise SegmentCorrupt(
                f"level {self.level}: segment rows sum {self._starts[-1]} "
                f"!= manifest rows {self.rows}"
            )
        # segments verify on READ, not just at resume: verify=False (the
        # writer's own freshly-cut reader) defers each segment's content
        # CRC to its first read instead of skipping it, so a bit flipped
        # on disk between the cut and the replay is caught at consumption
        # time (once per segment; replays re-read segments every chunk and
        # must not re-CRC every time)
        self._read_verified: set = set()
        if verify:
            for s in manifest["segments"]:  # eager warm-up verify pass
                self._open(s)

    def _open(self, seg: dict) -> np.ndarray:
        path = os.path.join(self.dir, seg["name"])
        n = int(seg["rows"])
        if not os.path.exists(path) or os.path.getsize(path) != (
            _HEADER + 4 * n * self.K
        ):
            raise SegmentCorrupt(f"{path}: missing or truncated")
        arr = np.memmap(
            path, dtype=np.uint32, mode="r", offset=_HEADER,
            shape=(n, self.K),
        )
        if seg["name"] not in self._read_verified:
            if zlib.crc32(arr.tobytes()) != int(seg["crc32"]):
                raise SegmentCorrupt(f"{path}: content CRC mismatch")
            self._read_verified.add(seg["name"])
        return arr

    def paths(self) -> list:
        return [os.path.join(self.dir, s["name"]) for s in self.man["segments"]]

    def slice(self, start: int, stop: int) -> np.ndarray:
        stop = min(stop, self.rows)
        if start >= stop:
            return np.empty((0, self.K), np.uint32)
        out = np.empty((stop - start, self.K), np.uint32)
        at = 0
        s0 = int(np.searchsorted(self._starts, start, side="right")) - 1
        for i in range(s0, len(self.man["segments"])):
            seg_start = int(self._starts[i])
            if seg_start >= stop:
                break
            arr = self._open(self.man["segments"][i])
            a = max(0, start - seg_start)
            b = min(arr.shape[0], stop - seg_start)
            out[at : at + (b - a)] = arr[a:b]
            at += b - a
        return out

    def iter_chunks(self, chunk: int):
        for start in range(0, self.rows, chunk):
            yield start, self.slice(start, start + chunk)

    def row(self, i: int) -> np.ndarray:
        return self.slice(i, i + 1)[0]

    def read_all(self) -> np.ndarray:
        return self.slice(0, self.rows)
