"""Persistent state-space cache: checked explorations as keyed artifacts.

The port's own copy of ``kafka_specification_tpu/service/state_cache.py``,
with its on-disk format (the KRUN1 visited run, the boundary ``.npy``, the
chain and the self-digested ``entry.json``), so that either package serves
a chain-verified hit from the other's publish.

The model cache (service/kernel_cache.py) made the *built model* a keyed
O(1) artifact.  This module extends the same pattern to the *explored
state space itself*: the spilled-sorted-run + digest-chain machinery
(``storage/runs.py``, ``resilience/integrity.py``) already makes the
visited set a portable, verifiable object, so a completed check can publish it — and a repeat
check of the unchanged config becomes a **chain-verified cache hit** in
O(verify) instead of O(explore), while a config-delta check (a deeper
``max_depth`` over the same schema) **seeds its frontier from the cached
boundary** instead of re-exploring from Init.

Trust-but-verify is the whole contract.  A cache entry is never believed,
it is *re-proven* at lookup time:

- the entry record carries a self-digest (sha256 over its canonical
  JSON) — bit rot in the metadata is caught before anything is trusted;
- the visited set is a ``KRUN1`` sorted-run file (storage/runs.py) whose
  content CRC is verified on open, exactly like a spill run;
- the per-level digest chain must re-verify (hash-chain linkage + level
  counts, resilience.integrity.chain_array_errors) and its cumulative
  (count, xor, sum) multiset digest must equal the digest of the stored
  visited set — a CRC-consistent corruption (flipped before the CRC was
  computed) is still caught, the same property checkpoint chains have;
- the boundary frontier's fingerprint multiset must digest to the
  chain's entry at the boundary depth (the same check the engine runs at
  every level boundary on the seeded frontier, so a corrupt boundary is
  caught twice: here and in-engine).

ANY failure — verification, version skew, unreadable files, a publish
ENOSPC — degrades to a cold run with a typed ``cache-fallback`` event.
The cache can cost a re-exploration; it can never cost a wrong verdict.

Key schema (``kspec-state-cache/1``).  An entry is keyed by everything
that shapes the *verdict*: module, kernel source (emitted/hand),
canonical CONSTANTS, the ORDERED invariant selection (first-violation
order is semantic), constraints, the deadlock flag, and the
``max_depth``/``max_states`` bounds.  Engine knobs (pipeline, backend,
chunk size, overlap) deliberately do NOT key: the bit-identity contracts
pin the verdict invariant across all of them.  Bounds split the key in
two levels on disk::

    <root>/<base16>/                          base = everything but bounds
        d<depth>-s<states>/entry.json         one entry per bounds pair
        d<depth>-s<states>/visited-<u>.run    sorted u64 fingerprints
                                              (KRUN1)
        d<depth>-s<states>/boundary-<u>.npy   deepest level's packed rows

so a delta lookup (same base, larger depth bound) is a directory scan of
the base, not of the whole cache.  The cache root defaults to
``<svc>/state-cache`` but may be any shared directory
(``--state-cache-dir`` / ``$KSPEC_STATE_CACHE_DIR``): entries are
content-addressed and re-proven on every read, so N hosts can share ONE
namespace — a hit published by host A serves chain-verified from host B
with no coordination beyond the filesystem (cache federation).  Data filenames carry a per-publisher nonce ``<u>``
and travel inside the entry record; concurrent same-key publishes each
write their own data files and race only the atomic ``entry.json``
promote — last promote wins, both candidates were chain-valid, and the
loser's orphaned files are garbage-collected (grace-aged) by later
publishes.  A reader mid-race sees the OLD entry, the NEW entry, or a
verification failure that degrades to a typed cold run — never a torn
read.

Publication happens after a completed SOLO run (the daemon's singleton
path): the per-level packed rows the trace store already holds are
fingerprinted host-side (integrity.fingerprint_rows — the bit-exact
numpy twin of the engine kernel), folded into a fresh LevelDigestChain
(bit-identical to the engine's own chain by construction), and written
files-first / entry-last under tmp-write + atomic promote — a torn
publish leaves data files without an entry, which is invisible, never a
half-trusted artifact.  Violating runs publish a verdict-only entry (no
artifact: their exploration stopped at the violation, so there is no
boundary to seed from — but the verdict itself is deterministic and
cache-hittable).

Fault sites (resilience.faults): ``flip@cache:N`` corrupts the Nth
published artifact after its promote (the next lookup must reject it);
``enospc@cache:N`` raises at the Nth publish's entry-promote point (the
publish aborts cleanly; the job's verdict is untouched).

Must stay torch-free: lookup/verify run in the daemon but also in tests
and offline tooling on boxes with no accelerator stack.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..resilience import integrity as _integ
from ..resilience.faults import FaultPlan, corrupt_file
from .. import durable_io as _dio
from ..utils import clock as _clk
from ..storage.atomic import atomic_write
from ..storage.runs import RunCorrupt, SortedRun, write_run

CACHE_SCHEMA = "kspec-state-cache/1"

#: artifact-size gate: runs past this many distinct states publish a
#: verdict-only entry (the verdict is still O(verify)-hittable; only the
#: boundary-seeding artifact is skipped).  Env twin for operators.
DEFAULT_MAX_ARTIFACT_STATES = int(
    os.environ.get("KSPEC_STATE_CACHE_MAX_STATES", str(2_000_000))
)

#: per-process publish ordinal (flip@cache:N / enospc@cache:N fault
#: grammar counts publishes the way crash@merge counts merges)
_publish_ordinal = {"n": 0}


@dataclass(frozen=True)
class CacheKey:
    """Everything that shapes a verdict (see module docstring)."""

    module: str
    emitted: bool
    constants: tuple  # canonical ((name, value-or-tuple), ...) pairs
    invariants: tuple  # ORDERED — first-violation order is semantic
    constraints: tuple
    check_deadlock: bool
    max_depth: Optional[int] = None
    max_states: Optional[int] = None

    def base_dict(self) -> dict:
        return {
            "module": self.module,
            "emitted": bool(self.emitted),
            "constants": [[k, list(v) if isinstance(v, tuple) else v]
                          for k, v in self.constants],
            "invariants": list(self.invariants),
            "constraints": list(self.constraints),
            "check_deadlock": bool(self.check_deadlock),
        }

    def base_digest(self) -> str:
        payload = json.dumps(self.base_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def bounds_name(self) -> str:
        return bounds_name(self.max_depth, self.max_states)


def bounds_name(max_depth, max_states) -> str:
    return (
        f"d{'N' if max_depth is None else int(max_depth)}"
        f"-s{'N' if max_states is None else int(max_states)}"
    )


def canonical_constants(constants: dict) -> tuple:
    """Same canonical form as kernel_cache.canonical_constants (kept
    local so this module stays importable without the model builders)."""
    return tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(constants.items())
    )


def key_for_job(spec: dict, cfg, emitted: bool, invariants: tuple) -> CacheKey:
    """The cache key a queued job resolves to (the daemon's entry point).
    `invariants` must be the job's RESOLVED, ordered invariant names
    (kernel_cache.job_invariants) — exactly what a solo check builds."""
    return CacheKey(
        module=spec["module"],
        emitted=bool(emitted),
        constants=canonical_constants(cfg.constants),
        invariants=tuple(invariants),
        constraints=tuple(cfg.constraints),
        check_deadlock=bool(cfg.check_deadlock),
        max_depth=spec.get("max_depth"),
        max_states=spec.get("max_states"),
    )


@dataclass
class CacheHit:
    """Chain-verified exact (or exhausted-superset) hit: return the
    cached verdict, run nothing."""

    verdict: dict
    entry: dict
    reason: str = "exact"  # exact | exhausted-superset


@dataclass
class CacheSeed:
    """Config-delta hit: seed the engine from the cached boundary.
    `seed` plugs straight into engine.bfs.check(seed=...)."""

    seed: dict
    from_depth: int
    entry: dict


class VerifyFailed(Exception):
    """An entry failed its trust-but-verify pass (reason in args[0])."""


@dataclass
class StateSpaceCache:
    root: str
    fault_plan: Optional[FaultPlan] = None
    event: Optional[object] = None  # callable(kind, **fields)
    max_artifact_states: int = DEFAULT_MAX_ARTIFACT_STATES
    stats: dict = field(default_factory=lambda: {
        "hits": 0, "seeds": 0, "misses": 0, "publishes": 0, "fallbacks": 0,
    })

    # --- events -----------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self.event is not None:
            try:
                self.event(kind, **fields)
            except Exception:  # noqa: BLE001 — telemetry must not fail jobs
                pass

    def _fallback(self, key: CacheKey, reason: str, **fields) -> None:
        """THE typed degradation event: every path that abandons the
        cache (verify failure, version skew, read error, publish ENOSPC)
        funnels here, so operators see one event kind with a reason."""
        self.stats["fallbacks"] += 1
        self._event(
            "cache-fallback",
            reason=reason,
            module=key.module,
            base=key.base_digest(),
            bounds=key.bounds_name(),
            **fields,
        )

    # --- paths ------------------------------------------------------------
    def _entry_dir(self, key: CacheKey, bounds: Optional[str] = None) -> str:
        return os.path.join(
            self.root, key.base_digest(), bounds or key.bounds_name()
        )

    # --- lookup -----------------------------------------------------------
    def lookup(self, key: CacheKey):
        """-> CacheHit | CacheSeed | None.  Never raises: any failure is
        a cache-fallback event + None (the caller runs cold)."""
        try:
            entry = self._load_verified(key, key.bounds_name(),
                                        want_key=key)
        except VerifyFailed as e:
            self._fallback(key, str(e.args[0]))
            return None
        if entry is not None:
            self.stats["hits"] += 1
            self._event(
                "state-cache-hit",
                module=key.module,
                base=key.base_digest(),
                bounds=key.bounds_name(),
            )
            return CacheHit(verdict=dict(entry["verdict"]), entry=entry)
        delta = self._delta_lookup(key)
        if delta is None:
            self.stats["misses"] += 1
        return delta

    def _delta_lookup(self, key: CacheKey):
        """Same base key, smaller depth bound, clean run: seed from the
        cached boundary (or return the verdict outright when the cached
        run already exhausted the space — a larger bound cannot change
        an exhausted verdict)."""
        if key.max_states is not None:
            return None  # state-count bounds do not delta cleanly
        base_dir = os.path.join(self.root, key.base_digest())
        try:
            names = sorted(os.listdir(base_dir))
        except OSError:
            return None
        best = None  # (cached_max_depth, bounds_name)
        for name in names:
            if not name.endswith("-sN") or name == key.bounds_name():
                continue
            if not name.startswith("d") or name[1:2] == "N":
                continue
            try:
                cached_depth = int(name[1:].split("-")[0])
            except ValueError:
                continue
            if key.max_depth is not None and cached_depth >= key.max_depth:
                continue
            if best is None or cached_depth > best[0]:
                best = (cached_depth, name)
        if best is None:
            return None
        try:
            entry = self._load_verified(key, best[1], want_key=None)
        except VerifyFailed as e:
            self._fallback(key, str(e.args[0]), delta_base=best[1])
            return None
        if entry is None:
            return None
        v = entry["verdict"]
        if v.get("exit_code") != 0 or v.get("violation") is not None:
            return None  # only clean explorations seed
        if not entry.get("bound_limited"):
            # the cached run exhausted the state space below its bound:
            # any larger bound yields the identical verdict
            self.stats["hits"] += 1
            self._event(
                "state-cache-hit",
                module=key.module,
                base=key.base_digest(),
                bounds=key.bounds_name(),
                via=best[1],
                exhausted=True,
            )
            return CacheHit(
                verdict=dict(v), entry=entry, reason="exhausted-superset"
            )
        if entry.get("artifact") is None:
            return None  # verdict-only entry (size-gated): nothing to seed
        seed = self._seed_from_entry(entry)
        self.stats["seeds"] += 1
        self._event(
            "state-cache-seed",
            module=key.module,
            base=key.base_digest(),
            bounds=key.bounds_name(),
            from_depth=best[0],
        )
        return CacheSeed(seed=seed, from_depth=best[0], entry=entry)

    # --- verification -----------------------------------------------------
    def _load_verified(self, key: CacheKey, bounds: str,
                       want_key: Optional[CacheKey]) -> Optional[dict]:
        """Load + trust-but-verify one entry; None = absent, VerifyFailed
        = present but not trustworthy (the caller emits the fallback)."""
        d = self._entry_dir(key, bounds)
        path = os.path.join(d, "entry.json")
        try:
            with open(path) as fh:
                entry = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            raise VerifyFailed(f"entry-unreadable: {e}")
        if entry.get("schema") != CACHE_SCHEMA:
            raise VerifyFailed(
                f"version-skew: entry schema {entry.get('schema')!r} != "
                f"{CACHE_SCHEMA}"
            )
        if entry_self_digest(entry) != entry.get("self_digest"):
            raise VerifyFailed("entry-corrupt: self-digest mismatch")
        if want_key is not None and entry.get("key") != want_key.base_dict():
            raise VerifyFailed("entry-corrupt: key mismatch (collision?)")
        art = entry.get("artifact")
        if art is not None:
            # the verified arrays ride the entry so a seed consumer
            # never re-reads + re-CRCs the files it just proved
            # (_seed_from_entry pops them; exact hits just drop them)
            entry["_verified"] = self._verify_artifact(d, entry, art)
        _integ.count_check()
        return entry

    def _verify_artifact(self, d: str, entry: dict, art: dict) -> tuple:
        """The chain-verified part: visited-run CRC, chain linkage +
        counts, cumulative multiset digest, boundary digest.
        -> (visited_fps uint64, boundary uint32 rows), both verified."""
        levels = entry["verdict"]["levels"]
        chain_arr = np.asarray(art["chain"], np.uint64)
        errs = _integ.chain_array_errors(chain_arr, levels=levels)
        if errs:
            raise VerifyFailed(f"artifact-corrupt: {errs[0]}")
        try:
            run = SortedRun(d, art["visited"], verify=True)
        except RunCorrupt as e:
            raise VerifyFailed(f"artifact-corrupt: {e}")
        chain = _integ.LevelDigestChain.from_array(chain_arr)
        if _integ.digest_fps(np.asarray(run.arr)) != chain.cumulative():
            raise VerifyFailed(
                "artifact-corrupt: visited-set digest does not match the "
                "chain's cumulative (CRC-consistent corruption)"
            )
        boundary = self._read_boundary(d, art)
        depth = len(levels) - 1
        c, x, s = _integ.digest_fps(
            _integ.fingerprint_rows(boundary, bool(entry["exact64"]))
        )
        if (c, x, s) != tuple(chain.entries[depth][:3]):
            raise VerifyFailed(
                "artifact-corrupt: boundary frontier digest does not "
                f"match the chain entry at depth {depth}"
            )
        return np.asarray(run.arr, np.uint64).copy(), boundary

    def _read_boundary(self, d: str, art: dict) -> np.ndarray:
        import zlib

        path = os.path.join(d, art["boundary"]["name"])
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError as e:
            raise VerifyFailed(f"artifact-corrupt: boundary unreadable: {e}")
        if zlib.crc32(raw) != int(art["boundary"]["crc32"]):
            raise VerifyFailed("artifact-corrupt: boundary CRC mismatch")
        import io

        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        return np.ascontiguousarray(arr, np.uint32)

    def _seed_from_entry(self, entry: dict) -> dict:
        """verified entry -> the engine's seed dict, reusing the arrays
        the verification pass already read + proved (no second I/O or
        CRC on the serving hot path)."""
        visited, boundary = entry.pop("_verified")
        levels = [int(v) for v in entry["verdict"]["levels"]]
        return {
            "visited_fps": visited,
            "frontier": boundary,
            "levels": levels,
            "total": int(entry["verdict"]["distinct_states"]),
            "depth": len(levels) - 1,
            "digest_chain": np.asarray(
                entry["artifact"]["chain"], np.uint64
            ),
        }

    # --- publication ------------------------------------------------------
    def publish(self, key: CacheKey, verdict: dict, *,
                exact64: bool, lanes: int,
                level_rows: Optional[list] = None,
                diameter: Optional[int] = None) -> bool:
        """Publish one completed solo run.  `verdict` is the semantic
        kspec-verdict/1 subset (model/distinct_states/diameter/levels/
        violation/exit_code).  `level_rows` — per-level packed uint32
        rows (the trace store's rows column) — enables the seedable
        artifact; None (or a violating/oversized run) publishes a
        verdict-only entry.  Returns True iff an entry was promoted;
        every failure is a cache-fallback event, never an exception."""
        plan = self.fault_plan or FaultPlan("")
        _publish_ordinal["n"] += 1
        ordinal = _publish_ordinal["n"]
        clean = (
            verdict.get("exit_code") == 0
            and verdict.get("violation") is None
        )
        levels = verdict.get("levels") or []
        with_artifact = (
            clean
            and level_rows is not None
            and len(level_rows) == len(levels)
            and int(verdict.get("distinct_states") or 0)
            <= self.max_artifact_states
            and key.max_states is None
        )
        d = self._entry_dir(key)
        entry = {
            "schema": CACHE_SCHEMA,
            "created_unix": round(_clk.now(), 3),
            "key": key.base_dict(),
            "max_depth": key.max_depth,
            "max_states": key.max_states,
            "lanes": int(lanes),
            "exact64": bool(exact64),
            # bound-limited = the run stopped AT its depth bound with a
            # live frontier (diameter == max_depth); an exhausted run's
            # verdict covers every larger bound outright
            "bound_limited": bool(
                key.max_depth is not None
                and diameter is not None
                and int(diameter) == int(key.max_depth)
            ),
            "verdict": {
                k: verdict.get(k)
                for k in ("model", "distinct_states", "diameter", "levels",
                          "violation", "exit_code", "states_per_sec",
                          "seconds")
            },
            "artifact": None,
        }
        try:
            os.makedirs(d, exist_ok=True)
            art_files = []
            # per-publisher nonce: names this publisher's data files AND
            # privatises the entry-promote tmp, so two hosts racing the
            # same key never touch each other's in-flight bytes — the
            # promote itself (os.replace) is the only shared step, and
            # it is atomic: last promote wins
            nonce = f"{os.getpid():x}-{os.urandom(4).hex()}"
            if with_artifact:
                chain = _integ.LevelDigestChain()
                all_fps = []
                for depth, rows in enumerate(level_rows):
                    fps = _integ.fingerprint_rows(
                        np.ascontiguousarray(rows, np.uint32), exact64
                    )
                    chain.fold(fps)
                    chain.seal(depth, int(levels[depth]))
                    all_fps.append(fps)
                visited = np.sort(np.concatenate(all_fps))
                # per-publisher data filenames (the names travel in the
                # entry record, so lookup never assumes them): two hosts
                # racing the same key each write their OWN data files and
                # only the entry.json promote decides the winner — with a
                # shared fixed name, a reader could open A's entry over
                # B's half-written run, a torn read no verifier owes a
                # defense against
                run_path = os.path.join(d, f"visited-{nonce}.run")
                run_meta = write_run(run_path, visited)
                art_files.append(run_path)
                boundary = np.ascontiguousarray(level_rows[-1], np.uint32)
                b_path = os.path.join(d, f"boundary-{nonce}.npy")
                b_crc = _write_npy(b_path, boundary)
                art_files.append(b_path)
                entry["artifact"] = {
                    "visited": run_meta,
                    "boundary": {"name": os.path.basename(b_path),
                                 "crc32": b_crc,
                                 "rows": int(boundary.shape[0])},
                    "chain": [[int(v) for v in row]
                              for row in chain.to_array().tolist()],
                }
            entry["self_digest"] = entry_self_digest(entry)
            payload = json.dumps(entry, sort_keys=True).encode()
            atomic_write(
                os.path.join(d, "entry.json"),
                lambda fh: fh.write(payload),
                # the publish commit point: enospc@cache:N fires here,
                # after the data files but before the entry promote —
                # exactly what a real full disk does mid-publish (data
                # without an entry is invisible; nothing half-trusted)
                before_replace=lambda: plan.enospc("cache", ordinal),
                tmp_nonce=nonce,
            )
        except OSError as e:
            self._fallback(key, f"publish-error: {e}", ordinal=ordinal)
            return False
        except _integ.IntegrityError as e:
            # fold/seal count disagreement: the run's own accounting and
            # its rows diverged — do not publish a lying artifact
            self._fallback(key, f"publish-integrity: {e}", ordinal=ordinal)
            return False
        self.stats["publishes"] += 1
        self._event(
            "state-cache-publish",
            module=key.module,
            base=key.base_digest(),
            bounds=key.bounds_name(),
            artifact=entry["artifact"] is not None,
            states=verdict.get("distinct_states"),
        )
        # a lost promote race leaves this publisher's data files orphaned
        # in the entry dir: collect whatever the CURRENT entry does not
        # reference (grace-aged, so a racing publisher mid-write is never
        # collected before its own promote)
        self.collect_garbage(key)
        # flip@cache:N — the silent-corruption rehearsal: bytes flip in
        # the promoted artifact; the NEXT lookup's verification must
        # reject it (cache-fallback + cold run, never a wrong verdict)
        if plan.flip("cache", ordinal):
            target = (
                art_files[0]
                if art_files
                else os.path.join(d, "entry.json")
            )
            try:
                corrupt_file(target, n_bytes=16)
            except OSError:
                pass
        return True

    def collect_garbage(self, key: CacheKey,
                        grace_s: Optional[float] = None) -> list:
        """Remove data files in `key`'s entry dir that the CURRENT
        promoted entry does not reference — the loser's artifacts after a
        concurrent same-key publish race (both candidates were chain-
        valid; last entry-promote won; the loser's uniquely-named run/
        boundary files are invisible to every reader and now dead
        weight).  Files younger than the grace window (default
        KSPEC_STATE_CACHE_GC_GRACE_S, 120s) are kept: they may belong to
        a publisher whose promote hasn't landed yet.  Returns the
        basenames removed; never raises."""
        if grace_s is None:
            try:
                grace_s = float(
                    os.environ.get("KSPEC_STATE_CACHE_GC_GRACE_S", "120")
                )
            except ValueError:
                grace_s = 120.0
        d = self._entry_dir(key)
        referenced = {"entry.json"}
        try:
            with open(os.path.join(d, "entry.json")) as fh:
                entry = json.load(fh)
            art = entry.get("artifact") or {}
            if art.get("visited"):
                referenced.add(art["visited"]["name"])
            if art.get("boundary"):
                referenced.add(art["boundary"]["name"])
        except FileNotFoundError:
            # no entry was EVER promoted here: every data file is either
            # an in-flight publisher's (protected by the grace window
            # below) or a crashed first-publisher's orphan that no
            # future entry will ever reference (publishes mint fresh
            # nonce'd names), which would otherwise accumulate forever
            pass
        except (OSError, ValueError, KeyError, TypeError):
            # unreadable/torn entry: the atomic promote makes this
            # unreachable by crash, so treat it as transient (EIO, a
            # concurrent replace) — nothing is provably garbage
            return []
        # a referenced run's bloom sidecar is part of the artifact
        referenced |= {name + ".bloom" for name in tuple(referenced)}
        removed = []
        now = _clk.now()
        try:
            names = os.listdir(d)
        except OSError:
            return []
        for name in names:
            collectable = (
                name.endswith(".run") or name.endswith(".npy")
                # a loser's rebuilt-on-verify bloom sidecar dies with
                # its run
                or name.endswith(".bloom")
                # the startup janitor's rule: a publisher killed mid-atomic-write leaves a nonce'd
                # entry tmp that atomic_write's cleanup-on-raise never
                # saw — once it outlives the same grace window that
                # protects an in-flight promote, it is provably a
                # mid-write death's orphan (no manifest references tmp
                # names)
                or name.endswith(".tmp") or ".tmp." in name
            )
            if name in referenced or not collectable:
                continue
            path = os.path.join(d, name)
            try:
                if now - os.path.getmtime(path) < grace_s:
                    continue
                _dio.unlink(path)
                removed.append(name)
            except OSError:
                continue
        return removed

    def iter_entries(self):
        """Corpus view of this cache (see :func:`iter_corpus`)."""
        return iter_corpus(self.root)


def iter_corpus(root: str):
    """Yield every readable, self-consistent entry record under a cache
    root — the standing corpus view (the JAX package's sweep planner
    trains on it).  Light validation only: schema + self-digest
    (the cheap metadata checks); artifact chain verification is lookup's
    job, not a corpus scan's.  Bad entries are skipped, never fatal —
    this walks a live cache that concurrent daemons are promoting into.
    Each yielded dict gains ``_base``/``_bounds`` (its directory
    coordinates) for callers that need the on-disk address."""
    try:
        bases = sorted(os.listdir(root))
    except OSError:
        return
    for base in bases:
        base_dir = os.path.join(root, base)
        try:
            bounds_dirs = sorted(os.listdir(base_dir))
        except (OSError, NotADirectoryError):
            continue
        for bounds in bounds_dirs:
            path = os.path.join(base_dir, bounds, "entry.json")
            try:
                with open(path) as fh:
                    entry = json.load(fh)
            except (OSError, ValueError):
                continue
            if entry.get("schema") != CACHE_SCHEMA:
                continue
            if entry_self_digest(entry) != entry.get("self_digest"):
                continue
            entry["_base"] = base
            entry["_bounds"] = bounds
            yield entry


def entry_self_digest(entry: dict) -> str:
    """sha256 over the entry's canonical JSON minus the digest field —
    the metadata's own bit-rot detector."""
    body = {k: v for k, v in entry.items() if k != "self_digest"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


def _write_npy(path: str, arr: np.ndarray) -> int:
    import io
    import zlib

    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    raw = buf.getvalue()
    atomic_write(path, lambda fh: fh.write(raw))
    return zlib.crc32(raw)
