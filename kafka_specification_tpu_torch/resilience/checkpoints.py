"""Hardened checkpoint store: checksums, keep-last-K rotation, fallback.

The port's own copy of ``kafka_specification_tpu/resilience/checkpoints.py``,
writing and reading the same files, so a checkpoint written by either
package resumes in the other:

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

Per-shard part files (the sharded engine's per-host FpSet dumps,
``<base>.npz.host<p>``) rotate in lockstep with the main file, and a
generation is accepted only when every part it needs verifies at the
main's depth and mesh layout (``part_matches``).  ``ident_aliases`` are
extra identities accepted on load: the sharded engine passes its
pre-elastic ident, which baked the mesh layout in.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Optional

import numpy as np

from .. import durable_io as _dio
from .faults import corrupt_file

MANIFEST_KEY = "__manifest__"

#: machine-readable ownership contract (analysis/ownership.py), equal to
#: the JAX package's: the writer
#: thread runs `save()` — which mutates NOTHING on the store (files
#: only; every array handed to save_async is immutable from snapshot
#: time) — while the async bookkeeping (_async_job/_async_done and the
#: attached writer) belongs to the engine thread that polls it.
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
    file (no manifest) loads unchecked.  Module-level so the offline
    verifier (`verify_checkpoint_dir`) shares one definition of "this
    checkpoint file is intact" with the resume path."""
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


def part_matches(part_arrays: dict, match: dict) -> bool:
    """THE part-to-main pairing rule, shared by the resume path
    (CheckpointStore._find_part) and the offline verifier: a part pairs
    with a main iff every stamp the main carries (`depth`, and mesh
    layout when recorded) is either absent from the part (legacy) or
    equal."""
    return all(
        k not in part_arrays or v is None or int(part_arrays[k]) == v
        for k, v in match.items()
    )


class CheckpointStore:
    def __init__(
        self,
        directory: str,
        basename: str,
        ident: str,
        keep: int = 3,
        fault_plan=None,
        ident_aliases: tuple = (),
        validators: tuple = (),
    ):
        """`ident_aliases`: additional identity strings accepted on LOAD
        (new saves always stamp `ident`).  The sharded engine passes its
        pre-elastic ident form (which baked the mesh layout in) so
        checkpoints written by older code stay resumable on the same
        mesh after an upgrade.

        `validators`: callables ``arrays -> list[str]`` run on each main
        generation during load AFTER the CRC manifest passes; a non-empty
        return marks the generation corrupt and `load()` falls back to
        an older one exactly as it does for a checksum failure.  The
        engines pass the digest-chain validator
        (``resilience.integrity.checkpoint_chain_errors``) here — this is
        what makes the supervisor's restart-after-exit-76 policy "resume
        from the newest CHAIN-VERIFIED generation" without any new
        supervisor machinery: a CRC-consistent corrupted generation (one
        whose corruption happened before the write, so its checksums
        faithfully cover corrupt content) simply never resumes."""
        if not basename.endswith(".npz"):
            raise ValueError(f"basename must end in .npz, got {basename!r}")
        self.directory = directory
        self.basename = basename
        self.ident = ident
        self.ident_aliases = tuple(ident_aliases)
        self.keep = max(1, int(keep))
        self.fault_plan = fault_plan
        self.validators = tuple(validators)
        # async-write state (attach_writer): at most one save in flight,
        # completed (depth, path) pairs held until the engine polls them
        self._writer = None
        self._async_job = None
        self._async_done: list = []
        os.makedirs(directory, exist_ok=True)
        # startup janitor: a save killed mid-tmp-write leaves
        # `<name>.tmp.npz` behind (no manifest ever references it) —
        # sweep our own stem's strays so they never masquerade as disk
        # usage or confuse directory listings
        stem = basename[: -len(".npz")]
        for name in os.listdir(directory):
            if name.startswith(stem) and ".tmp." in name:
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    # --- paths ---------------------------------------------------------
    def path(self, gen: int = 0, part: Optional[str] = None) -> str:
        """Generation `gen` (0 = newest) of the main file or a part file.

        gen 0 keeps the legacy names (`<base>.npz`, `<base>.npz.<part>`) so
        pre-rotation directories and tooling stay compatible."""
        stem = self.basename[: -len(".npz")]
        name = self.basename if gen == 0 else f"{stem}.{gen}.npz"
        if part is not None:
            name += f".{part}"
        return os.path.join(self.directory, name)

    # --- save ----------------------------------------------------------
    def save(self, depth: int, arrays: dict, part: Optional[str] = None) -> str:
        """Checksummed write + rotate + atomic promote; returns the path.

        `depth` is stamped into the file (and must match across the main
        file and every part of a generation for a load to accept it)."""
        # lazy import: obs <-> resilience must stay acyclic at module level
        from ..obs import metrics as _met
        from ..obs import tracer as _obs

        arrays = dict(arrays)
        arrays["ident"] = self.ident
        arrays["depth"] = depth
        path = self.path(0, part)
        tmp = path + ".tmp.npz"
        try:
            with _obs.span("checkpoint-write", depth=depth, part=part or ""):
                # uncompressed (live fingerprints are high-entropy; zlib
                # only burns time — same rationale as the seed writer)
                np.savez(
                    tmp, **{MANIFEST_KEY: json.dumps(build_manifest(arrays))},
                    **arrays,
                )
                _dio.note_write(tmp, fsynced=False)
                if self.fault_plan is not None:
                    # torn-write rehearsal points: tmp written, nothing
                    # promoted (crash@ckpt:N and the full-disk twin
                    # enospc@ckpt:N — resilience.resources)
                    self.fault_plan.crash("ckpt", depth)
                    self.fault_plan.enospc("ckpt", depth)
                # shift existing generations up (newest-first so each
                # replace's target is the already-vacated slot);
                # generation keep-1 falls off
                for g in range(self.keep - 1, 0, -1):
                    src = self.path(g - 1, part)
                    if os.path.exists(src):
                        _dio.replace(src, self.path(g, part))
                _dio.replace(tmp, path)
        except BaseException:
            # a failed save (ENOSPC, injected fault, kill) must not leave
            # its tmp behind: the promoted generations are the durable
            # state and they are untouched
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
        the ENGINE snapshots the (small) level metadata, the digest
        chain, and the visited/frontier dumps synchronously — every
        array handed to save_async is immutable from then on — and the
        WRITER thread runs the pre-write chain verification, the
        checksummed tmp write, rotation and the atomic promote.  Errors
        (a real or injected ENOSPC, an injected crash) are stored on the
        job and re-raised on the engine thread at its next
        poll_async()/drain_async(), so the typed exit-75 path and the
        crash-restart contract fire exactly as in serial mode."""
        self._writer = worker

    def save_async(self, depth: int, arrays: dict,
                   part: Optional[str] = None,
                   pre_write=None, after_promote=None) -> None:
        """Queue one checksummed save on the attached writer thread.

        Serialized: a still-pending previous save is drained first (its
        error, if any, propagates here).  `pre_write` runs on the writer
        BEFORE the tmp write (the engines pass the digest-chain
        visited self-check — verification moves off the critical path
        but stays ahead of the promote, so detected corruption still
        never enters a checkpoint); `after_promote(path)` runs on the
        writer after the atomic promote (the chain read-back)."""
        assert self._writer is not None, "attach_writer first"
        # join the previous save WITHOUT consuming its completion record:
        # the engine's poll_async/drain_async is what processes the
        # (depth, path) pairs (barrier advance, durable-depth tracking)
        self._reap(block=True)

        def job():
            if pre_write is not None:
                pre_write()
            path = self.save(depth, arrays, part=part)
            if after_promote is not None:
                after_promote(path)
            return path

        self._async_job = (depth, self._writer.submit(
            "checkpoint-write-async", job
        ))

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
        """Non-blocking: -> newly completed [(depth, path)], raising any
        failed save's error on this (the engine's) thread."""
        self._reap(block=False)
        done, self._async_done = self._async_done, []
        return done

    def drain_async(self) -> list:
        """Block for the pending save (if any); -> completed pairs."""
        self._reap(block=True)
        done, self._async_done = self._async_done, []
        return done

    def prune(self, keep_gens: int = 1) -> list:
        """Resource reclamation: unlink every rotated generation (mains
        AND parts) at index >= `keep_gens`, keeping the newest.  Used by
        the engines' soft-breach reclaim right after a fresh save — the
        surviving generation's manifest is the one the deletion barrier
        may then be flushed against — and by the supervisor's --reclaim
        policy between attempts.  Returns the removed paths."""
        removed = []
        stem = self.basename[: -len(".npz")]
        pat = re.compile(
            re.escape(stem) + r"\.(\d+)\.npz(\..+)?$"
        )
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

    # --- load ----------------------------------------------------------
    def _verify(self, path: str) -> dict:
        return verify_file(path)

    def _check_ident(self, path: str, arrays: dict) -> None:
        found = str(arrays["ident"]) if "ident" in arrays else "<none>"
        if found != self.ident and found not in self.ident_aliases:
            raise ValueError(
                f"checkpoint at {path} was written by a different "
                f"model/config:\n  checkpoint: {found}\n  this run:   {self.ident}"
            )

    def generations(self) -> list:
        """Generation indices present on disk (main files), newest first."""
        return [g for g in range(self.keep) if os.path.exists(self.path(g))]

    def _find_part(self, part: str, match: dict, errors: list):
        """Newest verifying generation of `part` matching `match`, or None.

        Parts are matched to the main file BY LEVEL (plus any mesh-layout
        stamps the writer recorded — `match` maps array name -> required
        value), not by generation index: part and main chains rotate at
        slightly different moments (every process promotes its part
        before the coordinator promotes the main file), so a crash in
        between skews the chains by one — pairing by index would make
        every generation look torn and defeat fallback entirely.  The
        layout stamps matter after an elastic re-shard: the re-saved main
        and a stale old-layout part can share a depth, and splicing them
        would resume half a re-shard."""
        for pg in range(self.keep):
            path = self.path(pg, part)
            if not os.path.exists(path):
                continue
            try:
                pa = self._verify(path)
            except CheckpointCorrupt as e:
                errors.append(str(e))
                continue
            self._check_ident(path, pa)
            if part_matches(pa, match):
                return pa
        return None

    def load(self, parts=()) -> Optional[tuple]:
        """Newest verifying generation -> (main_arrays, {part: arrays}, gen).

        Walks main generations newest -> oldest; a generation is accepted
        only when the main file verifies and every requested part has a
        verifying copy AT THE SAME LEVEL (the cross-shard level-consistency
        check — a crash between part and main writes must not splice two
        different levels; the part may live at a different generation
        index, see _find_part).  `parts` is a tuple of part names or a
        callable main_arrays -> tuple: the sharded engine derives the
        part set from the mesh layout recorded IN the main file, because
        an elastic resume may need a different process count's parts than
        the resuming job runs with.  Returns None when no checkpoint
        exists at all; raises CheckpointCorrupt when files exist but none
        verify; raises ValueError on an identity mismatch (never falls
        back past it)."""
        from ..obs import tracer as _obs  # lazy: cycle hygiene

        gens = self.generations()
        if not gens:
            return None
        errors = []
        for g in gens:
            try:
                with _obs.span("checkpoint-verify", generation=g):
                    main = self._verify(self.path(g))
            except CheckpointCorrupt as e:
                errors.append(str(e))
                continue
            self._check_ident(self.path(g), main)
            val_errors = [
                err for v in self.validators for err in v(main)
            ]
            if val_errors:
                # semantically corrupt (CRC-consistent content corruption,
                # e.g. a digest-chain mismatch): same fallback as a
                # checksum failure — never resume a generation whose
                # content fails validation
                errors.extend(
                    f"{self.path(g)}: {err}" for err in val_errors
                )
                continue
            depth = int(main["depth"]) if "depth" in main else None
            match = {"depth": depth}
            for k in ("mesh_D", "mesh_P"):
                if k in main:
                    match[k] = int(main[k])
            part_arrays = {}
            torn = False
            for p in (parts(main) if callable(parts) else parts):
                pa = self._find_part(p, match, errors)
                if pa is None:
                    errors.append(
                        f"generation {g}: no verifying part {p!r} at "
                        f"level {depth} (crash mid-checkpoint?)"
                    )
                    torn = True
                    break
                part_arrays[p] = pa
            if torn:
                continue
            if errors:
                import sys

                print(
                    f"[checkpoint] newest generation(s) failed verification; "
                    f"resuming from generation {g} (level {depth}):\n  "
                    + "\n  ".join(errors),
                    file=sys.stderr,
                )
                # run-correlated fallback record for `cli report`'s timeline
                _obs.event(
                    "checkpoint-fallback",
                    generation=g,
                    depth=depth,
                    errors=len(errors),
                )
            return main, part_arrays, g
        raise CheckpointCorrupt(
            "no checkpoint generation verified:\n  " + "\n  ".join(errors)
        )


# --- offline verification (`cli verify-checkpoint`) -----------------------

_CKPT_RE = re.compile(
    r"^(?P<stem>.+?)(?:\.(?P<gen>\d+))?\.npz(?:\.(?P<part>.+))?$"
)


def _scan_checkpoint_files(directory: str) -> dict:
    """-> {stem: {"mains": {gen: path}, "parts": {part: {gen: path}}}}."""
    stores: dict = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isfile(path) or ".tmp.npz" in name:
            continue
        m = _CKPT_RE.match(name)
        if m is None:
            continue
        st = stores.setdefault(m.group("stem"), {"mains": {}, "parts": {}})
        gen = int(m.group("gen") or 0)
        part = m.group("part")
        if part is None:
            st["mains"][gen] = path
        else:
            st["parts"].setdefault(part, {})[gen] = path
    return stores


def _resolve_spill(arrays: dict, spill_dir: str) -> dict:
    """Resolve a checkpoint's recorded storage manifest against the disk:
    every referenced run file / frontier segment must exist with the size
    its manifest entry implies — the checkpoint only *references* the
    disk tier, so a resumable
    generation is one whose references all still land."""
    from ..storage.runs import _HEADER as _RUN_HEADER

    problems = []
    checked = 0

    def check_run(run_dir: str, meta: dict) -> None:
        nonlocal checked
        checked += 1
        p = os.path.join(run_dir, meta["name"])
        if not os.path.isfile(p):
            problems.append(f"missing run file {p}")
            return
        want = _RUN_HEADER + 8 * int(meta["count"])
        size = os.path.getsize(p)
        if size != want:
            problems.append(f"{p}: size {size} != expected {want}")

    raw = json.loads(str(arrays["spill_manifest"]))
    if isinstance(raw, dict):  # single-device DiskTierStore manifest
        for meta in (raw.get("fpset") or {}).get("runs", ()):
            check_run(os.path.join(spill_dir, "fps"), meta)
        frontier_dir = os.path.join(spill_dir, "frontier")
        for seg in (raw.get("frontier") or {}).get("segments", ()):
            checked += 1
            p = os.path.join(frontier_dir, seg["name"])
            if not os.path.isfile(p):
                problems.append(f"missing frontier segment {p}")
    else:  # sharded: one tiered manifest per shard (None = unowned)
        for d, man in enumerate(raw):
            for meta in (man or {}).get("runs", ()):
                check_run(os.path.join(spill_dir, f"shard{d}"), meta)
    return {"ok": not problems, "files_checked": checked,
            "problems": problems}


def verify_checkpoint_dir(directory: str, spill_dir=None) -> dict:
    """Offline integrity report for a checkpoint directory, the front end
    of `cli verify-checkpoint`; it touches no card, so it runs on a box
    whose accelerator is unusable.  The report is the JAX package's, key
    for key.

    Checks, per checkpoint chain found in `directory`:

    - per-array CRC32 manifests of every main/part generation (the same
      `verify_file` the resume path trusts, without resuming anything);
    - cross-shard consistency: a generation is *resumable* only when
      every part file present has a verifying copy at the main file's
      depth (and mesh layout, when stamped) — the crash-between-promotes
      rule the sharded engine's per-host part files live by;
    - storage-manifest resolvability: a recorded `spill_manifest`'s run
      files / frontier segments must exist on disk at their manifest
      sizes (default spill dir: `<directory>/spill`, the engines'
      default placement; `--spill-dir` overrides).

    -> {"ok": bool, "dir": ..., "stores": [...]}: ok iff at least one
    chain exists and every chain has a fully-resumable generation.
    """
    directory = os.path.normpath(directory)
    spill_dir = spill_dir or os.path.join(directory, "spill")
    report: dict = {"dir": directory, "stores": [], "ok": False}
    if not os.path.isdir(directory):
        report["error"] = "not a directory"
        return report

    # checkpoint files are immutable once promoted; each part generation
    # may be consulted once per MAIN generation (keep of them), and a
    # full-CRC re-read of multi-GB fingerprint dumps per consult would
    # triple the verifier's disk traffic — memoize per path
    _verified: dict = {}

    def cached_verify(path: str) -> dict:
        if path not in _verified:
            try:
                _verified[path] = verify_file(path)
            except CheckpointCorrupt as e:
                _verified[path] = e
        out = _verified[path]
        if isinstance(out, CheckpointCorrupt):
            raise out
        return out
    for stem, files in sorted(_scan_checkpoint_files(directory).items()):
        store_rep = {"basename": f"{stem}.npz", "generations": [],
                     "ok": False}
        for gen in sorted(files["mains"]):
            path = files["mains"][gen]
            gen_rep: dict = {"gen": gen, "path": path, "ok": False,
                             "errors": []}
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
            # level-digest-chain validation (resilience.integrity): the
            # layer ABOVE the per-array CRCs — a generation whose content
            # was corrupted before the write has internally consistent
            # checksums over corrupt data, and only the chain (linkage,
            # levels agreement, cumulative visited digest) flags it
            from .integrity import checkpoint_chain_errors

            if "digest_chain" in arrays:
                chain_errs = checkpoint_chain_errors(arrays)
                gen_rep["digest_chain"] = "ok" if not chain_errs else "FAILED"
                gen_rep["errors"].extend(chain_errs)
            else:
                gen_rep["digest_chain"] = "absent"
            match = {"depth": depth}
            for k in ("mesh_D", "mesh_P"):
                if k in arrays:
                    gen_rep[k] = match[k] = int(arrays[k])
            # required parts come from the MAIN's own stamps (the same
            # rule the resume path's _parts_for applies): per-host
            # `host<p>` part files exist only for the host visited
            # backend (the ident records `backend=...`), and only for
            # multi-process layouts — a stamped device/device-hash main
            # or a single-process main needs none.  Stale parts from a
            # pre-elastic layout are then ignored rather than failing a
            # perfectly resumable directory.  Unstamped (legacy) mains
            # fall back to requiring every part found on disk.
            if "mesh_P" in arrays:
                host_backend = "|backend=host|" in (gen_rep.get("ident") or "")
                needed = (
                    [f"host{p}" for p in range(match["mesh_P"])]
                    if match["mesh_P"] > 1 and host_backend
                    else []
                )
            else:
                needed = sorted(files["parts"])
            gen_rep["parts"] = {}
            for part in needed:
                found = None
                gens = files["parts"].get(part, {})
                for pg in sorted(gens):  # gen 0 = newest, as in load()
                    try:
                        pa = cached_verify(gens[pg])
                    except CheckpointCorrupt as e:
                        gen_rep["errors"].append(str(e))
                        continue
                    if part_matches(pa, match):
                        found = pg
                        break
                    pa = None
                gen_rep["parts"][part] = found
                if found is None:
                    gen_rep["errors"].append(
                        f"no verifying part {part!r} at depth {depth}"
                    )
                elif "spill_manifest" in pa:
                    # multi-process disk-tier runs record each host's
                    # spill manifest ONLY in its part file — resolve it
                    # there or missing run files go undetected
                    psp = _resolve_spill(pa, spill_dir)
                    gen_rep.setdefault("part_spill", {})[part] = psp
                    gen_rep["errors"].extend(psp["problems"])
            if "spill_manifest" in arrays:
                gen_rep["spill"] = _resolve_spill(arrays, spill_dir)
                gen_rep["errors"].extend(gen_rep["spill"]["problems"])
            gen_rep["ok"] = not gen_rep["errors"]
        store_rep["ok"] = any(g["ok"] for g in store_rep["generations"])
        report["stores"].append(store_rep)
    report["ok"] = bool(report["stores"]) and all(
        s["ok"] for s in report["stores"]
    )
    return report


# KSPEC_TSAN=1 (test-only): assert THREAD_CONTRACT ownership on every
# attribute write (analysis/ownership.py); zero overhead otherwise
from ..analysis.ownership import bind_contract as _bind_contract  # noqa: E402

_bind_contract(globals(), THREAD_CONTRACT)
