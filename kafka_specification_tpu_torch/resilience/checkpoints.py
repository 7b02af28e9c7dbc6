"""Hardened checkpoint store: checksums, keep-last-K rotation, fallback.

The port's own copy of ``kafka_specification_tpu/resilience/checkpoints.py``
(single-file, synchronous saves), writing and reading the same files, so a
checkpoint written by either package resumes in the other:

- **Integrity**: every array in a checkpoint is CRC32-summed into a JSON
  manifest stored inside the npz (``__manifest__``).  Loads recompute and
  compare.
- **Keep-last-K rotation with atomic promote**: the newest generation
  lives at ``<base>.npz``, older ones at ``<base>.1.npz`` ...
  ``<base>.<K-1>.npz``.  A save writes a tmp file, shifts the existing
  generations up, then replaces the tmp into place, so a crash at any
  point leaves at most one generation torn.
- **Automatic fallback**: ``load()`` walks generations newest -> oldest
  and returns the first that verifies (checksums, then the validators,
  which the engine sets to the digest-chain check).  Only if every present
  generation fails does it raise ``CheckpointCorrupt``.

Identity mismatches (a checkpoint of another model, backend or invariant
set) are not corruption and raise ValueError at once: falling back past a
deliberate config change would resume the wrong search.

Not ported: the asynchronous writer (``save_async``; the JAX package's
``--overlap off`` is this serial path), fault-injection hooks, per-shard
part files and the offline verifier.
"""

from __future__ import annotations

import json
import os
import re
import sys
import zlib
from typing import Optional

import numpy as np

from .. import durable_io as _dio

MANIFEST_KEY = "__manifest__"


class CheckpointCorrupt(Exception):
    """No on-disk checkpoint generation passed verification."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def build_manifest(arrays: dict) -> dict:
    """name -> {crc32, dtype, shape} for every array in a checkpoint."""
    man = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        man[k] = {"crc32": _crc(a), "dtype": str(a.dtype), "shape": list(a.shape)}
    return man


def verify_file(path: str) -> dict:
    """Load `path` into a plain dict, checking the manifest checksums.

    Raises CheckpointCorrupt on any read/CRC/manifest failure.  A legacy
    file (no manifest) loads unchecked."""
    try:
        with np.load(path, allow_pickle=False) as snap:
            arrays = {k: snap[k] for k in snap.files}
    except Exception as e:  # zipfile/np errors: torn or rotted file
        raise CheckpointCorrupt(f"{path}: unreadable ({e})") from e
    man_raw = arrays.pop(MANIFEST_KEY, None)
    if man_raw is None:
        return arrays  # legacy pre-manifest checkpoint
    try:
        manifest = json.loads(str(man_raw))
    except ValueError as e:
        raise CheckpointCorrupt(f"{path}: bad manifest ({e})") from e
    if set(manifest) != set(arrays):
        raise CheckpointCorrupt(
            f"{path}: manifest/content mismatch "
            f"({sorted(set(manifest) ^ set(arrays))})"
        )
    for k, meta in manifest.items():
        if _crc(arrays[k]) != meta["crc32"]:
            raise CheckpointCorrupt(f"{path}: checksum mismatch on {k!r}")
    return arrays


class CheckpointStore:
    def __init__(self, directory: str, basename: str, ident: str, keep: int = 3,
                 validators: tuple = ()):
        """`validators`: callables ``arrays -> list[str]`` run on each
        generation during load after its checksums pass; a non-empty
        return marks the generation corrupt, and `load()` falls back to an
        older one as it does for a checksum failure."""
        if not basename.endswith(".npz"):
            raise ValueError(f"basename must end in .npz, got {basename!r}")
        self.directory = directory
        self.basename = basename
        self.ident = ident
        self.keep = max(1, int(keep))
        self.validators = tuple(validators)
        os.makedirs(directory, exist_ok=True)
        # startup janitor: a save killed mid-write leaves `<name>.tmp.npz`
        # behind, which no generation names
        stem = basename[: -len(".npz")]
        for name in os.listdir(directory):
            if name.startswith(stem) and ".tmp." in name:
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    def path(self, gen: int = 0) -> str:
        """Generation `gen` (0 = newest)."""
        stem = self.basename[: -len(".npz")]
        name = self.basename if gen == 0 else f"{stem}.{gen}.npz"
        return os.path.join(self.directory, name)

    def save(self, depth: int, arrays: dict) -> str:
        """Checksummed write + rotate + atomic promote; returns the path.
        `depth` and the identity are stamped into the file."""
        arrays = dict(arrays)
        arrays["ident"] = self.ident
        arrays["depth"] = depth
        path = self.path(0)
        tmp = path + ".tmp.npz"
        try:
            # uncompressed: live fingerprints are high-entropy
            np.savez(tmp, **{MANIFEST_KEY: json.dumps(build_manifest(arrays))}, **arrays)
            # shift existing generations up, newest first, so each
            # replace's target is the already-vacated slot; generation
            # keep-1 falls off
            for g in range(self.keep - 1, 0, -1):
                src = self.path(g - 1)
                if os.path.exists(src):
                    _dio.replace(src, self.path(g))
            _dio.replace(tmp, path)
        except BaseException:
            # a failed save must not leave its tmp behind; the promoted
            # generations are untouched
            try:
                _dio.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def prune(self, keep_gens: int = 1) -> list:
        """Unlink every rotated generation at index >= `keep_gens`, keeping
        the newest.  Returns the removed paths."""
        removed = []
        stem = self.basename[: -len(".npz")]
        pat = re.compile(re.escape(stem) + r"\.(\d+)\.npz$")
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m is None or int(m.group(1)) < keep_gens:
                continue
            p = os.path.join(self.directory, name)
            try:
                _dio.unlink(p)
                removed.append(p)
            except OSError:
                pass
        return removed

    def _check_ident(self, path: str, arrays: dict) -> None:
        found = str(arrays["ident"]) if "ident" in arrays else "<none>"
        if found != self.ident:
            raise ValueError(
                f"checkpoint at {path} was written by a different "
                f"model/config:\n  checkpoint: {found}\n  this run:   {self.ident}"
            )

    def generations(self) -> list:
        """Generation indices present on disk, newest first."""
        return [g for g in range(self.keep) if os.path.exists(self.path(g))]

    def load(self) -> Optional[tuple]:
        """Newest verifying generation -> (arrays, gen).

        None when no checkpoint exists; CheckpointCorrupt when files exist
        but none verifies; ValueError on an identity mismatch (never falls
        back past it)."""
        gens = self.generations()
        if not gens:
            return None
        errors = []
        for g in gens:
            try:
                main = verify_file(self.path(g))
            except CheckpointCorrupt as e:
                errors.append(str(e))
                continue
            self._check_ident(self.path(g), main)
            val_errors = [err for v in self.validators for err in v(main)]
            if val_errors:
                # content corruption the checksums cover faithfully (e.g. a
                # digest-chain mismatch): the same fallback
                errors.extend(f"{self.path(g)}: {err}" for err in val_errors)
                continue
            if errors:
                depth = int(main["depth"]) if "depth" in main else None
                print(
                    f"[checkpoint] newest generation(s) failed verification; "
                    f"resuming from generation {g} (level {depth}):\n  "
                    + "\n  ".join(errors),
                    file=sys.stderr,
                )
            return main, g
        raise CheckpointCorrupt("no checkpoint generation verified:\n  " + "\n  ".join(errors))
