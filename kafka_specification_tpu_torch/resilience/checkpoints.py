"""Hardened checkpoint store: checksums, keep-last-K rotation, fallback.

The port's own copy of ``kafka_specification_tpu/resilience/checkpoints.py``
(single-file saves), writing and reading the same files, so a checkpoint
written by either package resumes in the other:

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

Fault injection (``resilience/faults.py``): ``crash@ckpt:N`` and
``enospc@ckpt:N`` fire between the tmp write and the promote, and
``corrupt_ckpt`` corrupts a generation right after its promote.
``verify_checkpoint_dir`` is the offline verifier behind ``cli
verify-checkpoint``.

The asynchronous writer (``attach_writer``/``save_async``, the overlap
layer's ``kspec-ckpt`` thread, ``overlap.py``): the engine snapshots
every array synchronously (the device-to-host copies happen there) and
the writer thread runs the pre-write chain check, the checksummed write,
the rotation and the promote; its errors re-raise on the engine thread at
``poll_async``/``drain_async``.  The files are the synchronous save's.

Not ported: the sharded engine's per-shard part files and per-shard spill
manifests (the verifier reads single-device directories, the only ones
the port writes).
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
from .faults import corrupt_file

MANIFEST_KEY = "__manifest__"

#: machine-readable ownership contract (analysis/ownership.py), equal to
#: the JAX package's: the writer thread runs `save()` — which mutates
#: NOTHING on the store (files only; every array handed to save_async is
#: immutable from snapshot time) — while the async bookkeeping
#: (_async_job/_async_done and the attached writer) belongs to the engine
#: thread that polls it.  (`ident_aliases`, the sharded engine's, names no
#: attribute of the port's store.)
THREAD_CONTRACT = {
    "schema": "kspec-ownership/1",
    "classes": {
        "CheckpointStore": {
            "engine_only": ["_writer", "_async_job", "_async_done"],
            "immutable_after_init": ["directory", "basename", "ident",
                                     "ident_aliases", "keep",
                                     "fault_plan", "validators"],
            "worker_safe": ["save"],
        },
    },
}


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
                 validators: tuple = (), fault_plan=None):
        """`validators`: callables ``arrays -> list[str]`` run on each
        generation during load after its checksums pass; a non-empty
        return marks the generation corrupt, and `load()` falls back to an
        older one as it does for a checksum failure.  `fault_plan`: the
        run's ``FaultPlan`` (its ckpt sites fire in `save`)."""
        if not basename.endswith(".npz"):
            raise ValueError(f"basename must end in .npz, got {basename!r}")
        self.directory = directory
        self.basename = basename
        self.ident = ident
        self.keep = max(1, int(keep))
        self.validators = tuple(validators)
        self.fault_plan = fault_plan
        # async-write state (attach_writer): at most one save in flight,
        # completed (depth, path) pairs held until the engine polls them
        self._writer = None
        self._async_job = None
        self._async_done: list = []
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
        # lazy import: obs <-> resilience must stay acyclic at module level
        from ..obs import metrics as _met
        from ..obs import tracer as _obs

        arrays = dict(arrays)
        arrays["ident"] = self.ident
        arrays["depth"] = depth
        path = self.path(0)
        tmp = path + ".tmp.npz"
        try:
            # the JAX package's span attributes: the single-device file
            # is its part ""
            with _obs.span("checkpoint-write", depth=depth, part=""):
                # uncompressed: live fingerprints are high-entropy
                np.savez(tmp, **{MANIFEST_KEY: json.dumps(build_manifest(arrays))}, **arrays)
                if self.fault_plan is not None:
                    # torn-write rehearsal points: tmp written, nothing
                    # promoted (crash@ckpt:N and its full-disk twin
                    # enospc@ckpt:N)
                    self.fault_plan.crash("ckpt", depth)
                    self.fault_plan.enospc("ckpt", depth)
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
        _met.inc("kspec_checkpoint_writes_total")
        if self.fault_plan is not None and self.fault_plan.should_corrupt(depth):
            corrupt_file(path)
        return path

    # --- async writes (KSPEC_OVERLAP) -----------------------------------
    def attach_writer(self, worker) -> None:
        """Enable :meth:`save_async` on an :class:`~..overlap.AsyncWorker`.

        The split of responsibilities is the async-checkpoint contract:
        the ENGINE snapshots the level metadata, the digest chain, and the
        visited/frontier dumps synchronously — every array handed to
        save_async is immutable from then on — and the WRITER thread runs
        the pre-write chain verification, the checksummed tmp write,
        rotation and the atomic promote.  Errors (a real or injected
        ENOSPC, an injected crash) are stored on the job and re-raised on
        the engine thread at its next poll_async()/drain_async(), so the
        typed exit-75 path and the crash-restart contract fire exactly as
        in serial mode."""
        self._writer = worker

    def save_async(self, depth: int, arrays: dict, pre_write=None,
                   after_promote=None) -> None:
        """Queue one checksummed save on the attached writer thread.

        Serialized: a still-pending previous save is drained first (its
        error, if any, propagates here).  `pre_write` runs on the writer
        BEFORE the tmp write (the engine passes the digest-chain visited
        self-check — verification moves off the critical path but stays
        ahead of the promote, so detected corruption still never enters a
        checkpoint); `after_promote(path)` runs on the writer after the
        atomic promote (the chain read-back)."""
        assert self._writer is not None, "attach_writer first"
        # join the previous save WITHOUT consuming its completion record:
        # the engine's poll_async/drain_async is what processes the
        # (depth, path) pairs (barrier advance, durable-depth tracking)
        self._reap(block=True)

        def job():
            if pre_write is not None:
                pre_write()
            path = self.save(depth, arrays)
            if after_promote is not None:
                after_promote(path)
            return path

        self._async_job = (depth, self._writer.submit("checkpoint-write-async", job))

    def _reap(self, block: bool) -> None:
        if self._async_job is None:
            return
        depth, job = self._async_job
        if not block and not job.done.is_set():
            return
        try:
            # wait() re-raises THIS job's error (and consumes it from the
            # worker's failed queue) — never some other client's failure
            path = self._writer.wait(job)
        except BaseException:
            self._async_job = None
            raise
        self._async_job = None
        self._async_done.append((depth, path))

    def poll_async(self) -> list:
        """Non-blocking join: -> completed (depth, path) pairs since the
        last poll; re-raises a failed write's error."""
        self._reap(block=False)
        done, self._async_done = self._async_done, []
        return done

    def drain_async(self) -> list:
        """Block for the pending save (if any); -> completed pairs."""
        self._reap(block=True)
        done, self._async_done = self._async_done, []
        return done

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
        from ..obs import tracer as _obs  # lazy: cycle hygiene

        gens = self.generations()
        if not gens:
            return None
        errors = []
        for g in gens:
            try:
                with _obs.span("checkpoint-verify", generation=g):
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
                # run-correlated fallback record for `cli report`'s timeline
                _obs.event("checkpoint-fallback", generation=g, depth=depth, errors=len(errors))
            return main, g
        raise CheckpointCorrupt("no checkpoint generation verified:\n  " + "\n  ".join(errors))


# --- offline verification (`cli verify-checkpoint`) -----------------------

_CKPT_RE = re.compile(r"^(?P<stem>.+?)(?:\.(?P<gen>\d+))?\.npz$")


def _scan_checkpoint_files(directory: str) -> dict:
    """-> {stem: {gen: path}}: the checkpoint chains in `directory`."""
    stores: dict = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isfile(path) or ".tmp.npz" in name:
            continue
        m = _CKPT_RE.match(name)
        if m is not None:
            stores.setdefault(m.group("stem"), {})[int(m.group("gen") or 0)] = path
    return stores


def _resolve_spill(arrays: dict, spill_dir: str) -> dict:
    """Resolve a checkpoint's recorded storage manifest against the disk:
    every referenced run file / frontier segment must exist with the size
    its manifest entry implies — the checkpoint only *references* the
    disk tier, so a resumable generation is one whose references all
    still land."""
    from ..storage.runs import _HEADER as _RUN_HEADER

    problems = []
    checked = 0
    man = json.loads(str(arrays["spill_manifest"]))
    for meta in (man.get("fpset") or {}).get("runs", ()):
        checked += 1
        p = os.path.join(spill_dir, "fps", meta["name"])
        if not os.path.isfile(p):
            problems.append(f"missing run file {p}")
            continue
        want = _RUN_HEADER + 8 * int(meta["count"])
        size = os.path.getsize(p)
        if size != want:
            problems.append(f"{p}: size {size} != expected {want}")
    for seg in (man.get("frontier") or {}).get("segments", ()):
        checked += 1
        p = os.path.join(spill_dir, "frontier", seg["name"])
        if not os.path.isfile(p):
            problems.append(f"missing frontier segment {p}")
    return {"ok": not problems, "files_checked": checked, "problems": problems}


def verify_checkpoint_dir(directory: str, spill_dir=None) -> dict:
    """Offline integrity report for a checkpoint directory, the front end
    of `cli verify-checkpoint`; it touches no card, so it runs on a box
    whose accelerator is unusable.  The report is the JAX package's, key
    for key, for a single-device directory (a sharded engine's part files
    are not read: the port writes none, and its report lists no parts).

    Checks, per checkpoint chain found in `directory`:

    - per-array CRC32 manifests of every generation (the same
      `verify_file` the resume path trusts, without resuming anything);
    - the level digest chain, where the generation carries one;
    - storage-manifest resolvability: a recorded `spill_manifest`'s run
      files / frontier segments must exist on disk at their manifest
      sizes (default spill dir: `<directory>/spill`, the engines'
      default placement; `--spill-dir` overrides).

    -> {"ok": bool, "dir": ..., "stores": [...]}: ok iff at least one
    chain exists and every chain has a fully-resumable generation.
    """
    from .integrity import checkpoint_chain_errors

    directory = os.path.normpath(directory)
    spill_dir = spill_dir or os.path.join(directory, "spill")
    report: dict = {"dir": directory, "stores": [], "ok": False}
    if not os.path.isdir(directory):
        report["error"] = "not a directory"
        return report
    for stem, mains in sorted(_scan_checkpoint_files(directory).items()):
        store_rep = {"basename": f"{stem}.npz", "generations": [], "ok": False}
        for gen in sorted(mains):
            path = mains[gen]
            gen_rep: dict = {"gen": gen, "path": path, "ok": False, "errors": []}
            store_rep["generations"].append(gen_rep)
            try:
                arrays = verify_file(path)
            except CheckpointCorrupt as e:
                gen_rep["errors"].append(str(e))
                continue
            depth = int(arrays["depth"]) if "depth" in arrays else None
            gen_rep["depth"] = depth
            if "ident" in arrays:
                gen_rep["ident"] = str(arrays["ident"])
            # the level digest chain, the layer ABOVE the per-array CRCs: a
            # generation corrupted before its write has consistent checksums
            # over corrupt data, and only the chain flags it
            if "digest_chain" in arrays:
                chain_errs = checkpoint_chain_errors(arrays)
                gen_rep["digest_chain"] = "ok" if not chain_errs else "FAILED"
                gen_rep["errors"].extend(chain_errs)
            else:
                gen_rep["digest_chain"] = "absent"
            gen_rep["parts"] = {}
            if "spill_manifest" in arrays:
                gen_rep["spill"] = _resolve_spill(arrays, spill_dir)
                gen_rep["errors"].extend(gen_rep["spill"]["problems"])
            gen_rep["ok"] = not gen_rep["errors"]
        store_rep["ok"] = any(g["ok"] for g in store_rep["generations"])
        report["stores"].append(store_rep)
    report["ok"] = bool(report["stores"]) and all(s["ok"] for s in report["stores"])
    return report


# KSPEC_TSAN=1 (test-only): assert THREAD_CONTRACT ownership on every
# attribute write (analysis/ownership.py); no cost otherwise
from ..analysis.ownership import bind_contract as _bind_contract  # noqa: E402

_bind_contract(globals(), THREAD_CONTRACT)
