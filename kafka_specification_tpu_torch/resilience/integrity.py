"""The level digest chain: order-invariant per-level digests of the new
states' fingerprints, linked into a hash chain, and the typed error.

The port's own copy of ``kafka_specification_tpu/resilience/integrity.py``
(the chain, its checkpoint validators and the numpy fingerprint twin), so
the two packages compute the same chain for the same exploration and
accept each other's checkpoints:

- :class:`LevelDigestChain` keeps, per BFS level, ``(count, xor, sum)``
  over the level's new-state 64-bit fingerprints (XOR and wrapping sum
  commute, so chunk order, backend and pipeline cannot change a digest)
  and a splitmix64 link that commits each level to every earlier one.
  ``engine/bfs.py::check`` folds each chunk's winners, seals each level,
  verifies the frontier it is about to expand against its sealed entry,
  checks the visited set against the running total before each
  checkpoint save, and stamps the chain into every checkpoint as
  ``digest_chain`` (uint64[L, 4]).
- :func:`fingerprint_rows` is the numpy twin of the fingerprint (K1's
  plain function), for host code and tests.
- :func:`checkpoint_chain_errors` is the checkpoint validator: chain
  linkage, per-level counts against ``levels``, and the cumulative digest
  of the stored visited set.
- :func:`spill_run_errors` CRC-verifies the spill runs a disk-tier
  checkpoint references, :func:`readback_chain` re-reads a freshly
  promoted checkpoint's chain (what catches ``flip@ckpt``), and
  :func:`flip_bit` is the injected bit flip of the ``flip@`` faults.
- :class:`IntegrityError` is the typed terminal (``cli check`` exit 76);
  :func:`record_violation` stamps it into the run's spans and metrics, and
  :func:`count_check` counts each check made (``obs/``).

- :func:`shadow_rate` and :func:`sample_chunk` drive sampled shadow
  re-execution (``check(integrity_shadow=)``, ``--integrity-shadow``,
  ``$KSPEC_INTEGRITY_SHADOW``): a sampled chunk's emitted rows are
  fingerprinted again on the host (:func:`fingerprint_rows`) and held
  against K1's output before they reach the visited set.

``KSPEC_INTEGRITY=0`` turns the chain off, and the shadow with it.  Numpy
only.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

#: one past the resource exit (75): "the run's state failed an integrity
#: check"
EXIT_INTEGRITY = 76

ENV_DISABLE = "KSPEC_INTEGRITY"  # "0" disables the chain
ENV_SHADOW = "KSPEC_INTEGRITY_SHADOW"  # sampled shadow re-execution rate

_U64 = np.uint64


class IntegrityError(RuntimeError):
    """Typed terminal: a state-integrity check failed, so the run's data
    (not its progress) can no longer be trusted."""

    def __init__(self, site: str, detail: str = "", depth=None):
        self.site = site  # frontier | fpset | ckpt | chain | storage | shadow
        self.detail = detail
        self.depth = depth
        super().__init__(
            f"INTEGRITY_VIOLATION[{site}]"
            + (f" at level {depth}" if depth is not None else "")
            + (f": {detail}" if detail else "")
        )


def enabled() -> bool:
    """Always on unless ``$KSPEC_INTEGRITY`` is "0"."""
    return os.environ.get(ENV_DISABLE, "1") != "0"


def shadow_rate(arg: Optional[float] = None) -> float:
    """Resolve the shadow re-execution sample rate: explicit arg >
    $KSPEC_INTEGRITY_SHADOW > 0 (off)."""
    if arg is not None:
        rate = float(arg)
    else:
        rate = float(os.environ.get(ENV_SHADOW) or "0")
    if not (0.0 <= rate <= 1.0):
        raise ValueError(f"integrity shadow rate must be in [0, 1], got {rate}")
    return rate


def sample_chunk(depth: int, start: int, rate: float) -> bool:
    """Deterministic chunk sampler: the same (depth, chunk-start) is
    sampled identically on every run and after every resume, so shadow
    re-execution never perturbs bit-identity contracts."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = ((depth * 1000003 ^ start * 2654435761) * 0x9E3779B9) & 0xFFFFFFFF
    return h < rate * 4294967296.0


# --------------------------------------------------------------------------
# numpy twin of ops.fingerprint (bit-exact; pinned by tests)
# --------------------------------------------------------------------------

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_SEED_HI = np.uint32(0x9747B28C)
_SEED_LO = np.uint32(0x3C6EF372)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _murmur3_rows(rows: np.ndarray, seed: np.uint32) -> np.ndarray:
    k = rows.shape[-1]
    h = np.full(rows.shape[:-1], seed, np.uint32)
    for i in range(k):
        kx = rows[..., i] * _C1
        kx = _rotl32(kx, 15) * _C2
        h = h ^ kx
        h = _rotl32(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    return _fmix32(h ^ np.uint32(4 * k))


def fingerprint_rows(rows: np.ndarray, exact: bool) -> np.ndarray:
    """uint32[n, K] packed states -> uint64[n] fingerprints, bit-exact
    with ``ops.fingerprint.fingerprint_lanes`` (incl. the all-ones
    sentinel remap in hashed mode)."""
    rows = np.ascontiguousarray(rows, np.uint32)
    if exact:
        k = rows.shape[-1]
        lo = rows[..., 0]
        hi = rows[..., 1] if k > 1 else np.zeros_like(lo)
    else:
        with np.errstate(over="ignore"):
            hi = _murmur3_rows(rows, _SEED_HI)
            lo = _murmur3_rows(rows, _SEED_LO)
        sent = np.uint32(0xFFFFFFFF)
        lo = np.where((hi == sent) & (lo == sent), np.uint32(0xFFFFFFFE), lo)
    return (hi.astype(_U64) << _U64(32)) | lo.astype(_U64)


def pair_u64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 fingerprint lanes -> uint64 values."""
    return (np.asarray(hi).astype(_U64) << _U64(32)) | np.asarray(lo).astype(
        _U64
    )


# --------------------------------------------------------------------------
# multiset digests + the level chain
# --------------------------------------------------------------------------


def digest_fps(fps: np.ndarray) -> tuple:
    """-> (count, xor, sum) over a uint64 fingerprint multiset.  XOR and
    wrapping sum are commutative and associative, so the digest is
    invariant to chunking, shard order, and pipeline choice — and two
    digests combine by (count+count, xor^xor, sum+sum)."""
    fps = np.asarray(fps, _U64)
    if fps.size == 0:
        return 0, 0, 0
    with np.errstate(over="ignore"):
        x = int(np.bitwise_xor.reduce(fps))
        s = int(np.sum(fps, dtype=_U64))
    return int(fps.size), x, s


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def chain_link(prev: int, count: int, xor: int, total: int) -> int:
    """One hash-chain step: the level-d chain value commits to the whole
    exploration prefix (every earlier level's digest), so two runs with
    equal chain values at depth d provably explored the same multiset
    sequence — the "a resumed run continues the SAME exploration" stamp."""
    h = _splitmix64(prev ^ _splitmix64(count))
    h = _splitmix64(h ^ xor)
    return _splitmix64(h ^ total)


class LevelDigestChain:
    """Per-level (count, xor, sum) digests + the linking hash chain.

    One instance per run; the engine drives this protocol:

        chain.fold(fps_u64)      # any number of times per level, any order
        chain.seal(depth, n)     # at the level boundary (n = new states)

    ``entries[d] = (count, xor, sum, chain)`` as python ints;
    ``to_array()``/``from_array()`` round-trip through the uint64[L, 4]
    checkpoint stamp.  ``anchored`` is False when the chain was rebuilt
    from a pre-integrity checkpoint (counts known from ``levels``, digests
    unknown) — digest-dependent checks then skip, linkage-dependent ones
    still run from the resume point on.
    """

    COLS = 4  # count, xor, sum, chain

    def __init__(self):
        self.entries: list[tuple] = []
        self.anchored = True
        self._fold_count = 0
        self._fold_xor = 0
        self._fold_sum = 0

    # --- build ----------------------------------------------------------
    def fold(self, fps) -> None:
        c, x, s = digest_fps(fps)
        self._fold_count += c
        self._fold_xor ^= x
        self._fold_sum = (self._fold_sum + s) & 0xFFFFFFFFFFFFFFFF

    def fold_digest(self, count: int, xor: int, total: int) -> None:
        """Fold a PRE-COMPUTED (count, xor, sum) multiset digest, bit
        for bit what :func:`digest_fps` gives over the same fingerprints.
        Digests combine by (c+c, x^x, s+s) (see digest_fps), so this is
        exactly fold() minus the recomputation."""
        self._fold_count += int(count)
        self._fold_xor ^= int(xor)
        self._fold_sum = (self._fold_sum + int(total)) & 0xFFFFFFFFFFFFFFFF

    def seal(self, depth: int, count: int) -> None:
        """Close level `depth` (must be len(entries)): the folded digest
        becomes the level's entry.  A count disagreement between the
        engine's accounting and the folded multiset is itself an
        integrity violation (it means novelty masks and emitted rows
        diverged somewhere between the kernel and the host)."""
        assert depth == len(self.entries), (depth, len(self.entries))
        if self._fold_count != int(count):
            raise IntegrityError(
                "chain",
                f"level {depth}: folded {self._fold_count} fingerprints "
                f"but the engine accounted {int(count)} new states",
                depth=depth,
            )
        prev = self.entries[-1][3] if self.entries else 0
        link = chain_link(prev, self._fold_count, self._fold_xor,
                          self._fold_sum)
        self.entries.append(
            (self._fold_count, self._fold_xor, self._fold_sum, link)
        )
        self._fold_count = self._fold_xor = self._fold_sum = 0

    def reset_fold(self) -> None:
        self._fold_count = self._fold_xor = self._fold_sum = 0

    # --- verify ---------------------------------------------------------
    def verify_level(self, depth: int, fps) -> None:
        """The level-boundary frontier check: the multiset about to be
        expanded must be exactly the multiset sealed when the level was
        discovered — a bit flipped in the frontier buffer (or a frontier
        loaded from a CRC-consistent corrupted checkpoint) lands here."""
        if not self.anchored or depth >= len(self.entries):
            return
        c, x, s = digest_fps(fps)
        want = self.entries[depth]
        if (c, x, s) != want[:3]:
            raise IntegrityError(
                "frontier",
                f"level {depth} frontier digest (n={c}, xor={x:#x}) does "
                f"not match the sealed chain entry (n={want[0]}, "
                f"xor={want[1]:#x}) — the frontier buffer was corrupted "
                f"after the level was discovered",
                depth=depth,
            )

    def cumulative(self) -> tuple:
        """(count, xor, sum) over EVERY sealed level — the digest of the
        whole visited set (levels are disjoint by construction)."""
        c = x = s = 0
        for ec, ex, es, _ in self.entries:
            c += ec
            x ^= ex
            s = (s + es) & 0xFFFFFFFFFFFFFFFF
        return c, x, s

    def verify_visited(self, fps, depth=None, what: str = "fpset") -> None:
        """The save-time self-check: the visited-set dump about to be
        checkpointed must digest to the chain's running total.  Runs
        BEFORE the write, so detected corruption never enters a
        checkpoint."""
        if not self.anchored:
            return
        c, x, s = digest_fps(fps)
        wc, wx, ws = self.cumulative()
        if (c, x, s) != (wc, wx, ws):
            raise IntegrityError(
                what,
                f"visited-set dump digest (n={c}, xor={x:#x}) does not "
                f"match the chain's cumulative digest (n={wc}, "
                f"xor={wx:#x}) — the fingerprint set was corrupted in "
                f"memory",
                depth=depth,
            )

    # --- (de)serialization ---------------------------------------------
    def to_array(self) -> np.ndarray:
        return np.asarray(
            [[c, x, s, h] for c, x, s, h in self.entries], _U64
        ).reshape(len(self.entries), self.COLS)

    @classmethod
    def from_array(cls, arr) -> "LevelDigestChain":
        chain = cls()
        for row in np.asarray(arr, _U64).reshape(-1, cls.COLS):
            chain.entries.append(tuple(int(v) for v in row))
        return chain

    @classmethod
    def from_levels(cls, levels) -> "LevelDigestChain":
        """Rebuild from a pre-integrity checkpoint: counts only, digests
        unknown — the chain keeps extending but is unanchored below the
        resume point."""
        chain = cls()
        chain.anchored = False
        prev = 0
        for n in levels:
            prev = chain_link(prev, int(n), 0, 0)
            chain.entries.append((int(n), 0, 0, prev))
        return chain


# --------------------------------------------------------------------------
# checkpoint-side validation (shared: resume fallback + offline verifier)
# --------------------------------------------------------------------------


def chain_array_errors(arr, levels=None) -> list:
    """Validate a stamped ``digest_chain`` array: internal hash-chain
    linkage, and per-level count agreement with the checkpoint's own
    ``levels`` array.  -> list of error strings (empty = ok)."""
    errors = []
    try:
        rows = np.asarray(arr, _U64).reshape(-1, LevelDigestChain.COLS)
    except (ValueError, TypeError) as e:
        return [f"digest chain unparseable: {e}"]
    prev = 0
    for d, (c, x, s, h) in enumerate(rows.tolist()):
        want = chain_link(prev, int(c), int(x), int(s))
        if int(h) != want:
            errors.append(
                f"digest chain broken at level {d}: stored link "
                f"{int(h):#x} != recomputed {want:#x}"
            )
            break
        prev = int(h)
    if levels is not None:
        lv = [int(v) for v in np.asarray(levels).ravel().tolist()]
        cc = [int(c) for c in rows[:, 0].tolist()]
        if lv != cc:
            errors.append(
                f"digest chain counts {cc[:8]}{'...' if len(cc) > 8 else ''} "
                f"disagree with the levels array "
                f"{lv[:8]}{'...' if len(lv) > 8 else ''}"
            )
    return errors


def visited_fps(arrays: dict):
    """The full visited-set uint64 multiset stored in a checkpoint (a
    sharded main's per-shard concatenations digest alike), or None when
    the generation carries none (a disk-tier generation's hot dump is a
    budget-bounded subset: its runs carry their own CRCs)."""
    if "spill_manifest" in arrays:
        return None
    if "host_fps" in arrays:
        return np.asarray(arrays["host_fps"], _U64)
    if "hash_hi" in arrays:
        return pair_u64(arrays["hash_hi"], arrays["hash_lo"])
    if "vhi" in arrays and "vn" in arrays:
        vhi = np.asarray(arrays["vhi"], np.uint32)
        vlo = np.asarray(arrays["vlo"], np.uint32)
        if vhi.ndim == 1:
            return pair_u64(vhi, vlo)
        # the sharded device backend: [D, w] per-shard prefixes of vn[d] rows
        vn = np.asarray(arrays["vn"]).ravel()
        parts = [pair_u64(vhi[d, : int(n)], vlo[d, : int(n)]) for d, n in enumerate(vn.tolist())]
        return np.concatenate(parts) if parts else np.empty(0, _U64)
    return None


def checkpoint_chain_errors(arrays: dict) -> list:
    """THE digest-chain validator for one checkpoint generation's arrays:
    linkage + levels agreement + (when the generation carries the full
    fingerprint set) cumulative visited digest.  The resume path passes
    it to ``CheckpointStore(validators=...)``: it flags a corrupted generation
    whose per-array CRCs still pass (the CRC faithfully checksums
    corrupted content; the chain does not).  Pre-integrity generations
    (no ``digest_chain``) validate vacuously."""
    if "digest_chain" not in arrays:
        return []
    errors = chain_array_errors(
        arrays["digest_chain"], levels=arrays.get("levels")
    )
    if "total" in arrays and not errors:
        rows = np.asarray(arrays["digest_chain"], _U64).reshape(
            -1, LevelDigestChain.COLS
        )
        tot = int(np.sum(rows[:, 0], dtype=_U64))
        if tot != int(arrays["total"]):
            errors.append(
                f"digest chain total {tot} != checkpoint total "
                f"{int(arrays['total'])}"
            )
    fps = visited_fps(arrays) if not errors else None
    if fps is not None:
        chain = LevelDigestChain.from_array(arrays["digest_chain"])
        chain.anchored = True
        c, x, s = digest_fps(fps)
        wc, wx, ws = chain.cumulative()
        if (c, x, s) != (wc, wx, ws):
            errors.append(
                f"visited fingerprint set digest (n={c}, xor={x:#x}) does "
                f"not match the digest chain's cumulative (n={wc}, "
                f"xor={wx:#x}) — CRC-consistent content corruption"
            )
    return errors


def spill_run_errors(directory: str, metas) -> list:
    """CRC-verify every spill run a checkpoint generation REFERENCES: the
    disk tier's load validator (a generation whose referenced run rotted
    on disk falls back to an older one).  -> error strings."""
    from ..storage.runs import RunCorrupt, SortedRun

    errs = []
    for meta in metas:
        try:
            SortedRun(directory, meta, verify=True)
        except RunCorrupt as e:
            errs.append(f"referenced spill run corrupt: {e}")
    return errs


def readback_chain(path: str, depth=None) -> None:
    """Cheap post-save verification of a freshly promoted checkpoint's
    chain members only (digest_chain / levels / total — the big arrays
    were self-checked BEFORE the write).  A CRC-consistent corruption
    inside the writer (flip@ckpt rehearses it: the manifest checksums
    corrupt content faithfully) is caught here, typed, before the run
    goes on trusting a poisoned newest generation.

    A path that stays missing is no error: the next save's keep-K rotation
    briefly renames generation 0 to ``.1`` before its replacement
    promotes, so a newer generation has superseded this one, and that
    save's own read-back verifies it."""
    for _attempt in range(3):
        try:
            with np.load(path, allow_pickle=False) as z:
                small = {k: z[k] for k in ("digest_chain", "levels", "total", "depth")
                         if k in z.files}
            break
        except FileNotFoundError:
            # wait out the rotation window
            time.sleep(0.02)
    else:
        return
    count_check()
    errs = checkpoint_chain_errors(small)
    if errs:
        raise IntegrityError(
            "ckpt",
            f"post-save chain read-back of {path} failed: " + "; ".join(errs),
            depth=depth,
        )


def record_violation(err: "IntegrityError") -> None:
    """The record-a-violation protocol (an obs event and a counter) of the
    engine's terminal handler."""
    from ..obs import metrics as _met  # lazy: cycle hygiene
    from ..obs import tracer as _obs

    _obs.event(
        "integrity-violation",
        site=err.site,
        depth=err.depth,
        detail=str(err)[:300],
    )
    _met.inc("kspec_integrity_violations_total")


def flip_bit(arr: np.ndarray) -> None:
    """In-place single-bit corruption of a (writable) numpy buffer — the
    injected bit flip of the flip@ faults.  Flips one bit in the middle
    byte so interval gates and shape checks still pass (the corruption
    must be detectable only by content checks)."""
    if arr.size == 0:
        return
    flat = arr.reshape(-1).view(np.uint8)
    flat[flat.shape[0] // 2] ^= 0x10


def count_check(n: int = 1) -> None:
    """Bump the integrity-check counter (the obs beat's numerator)."""
    from ..obs import metrics as _met

    _met.inc("kspec_integrity_checks_total", n)


def fold_shard_device_digests(chain: "LevelDigestChain", digests) -> None:
    """Fold per-shard level digests accumulated on the card into a chain:
    the sharded device level's twin of the single-device ``fold_digest``
    call.  `digests`: [D, 3] (count, xor, wrapping sum), one
    ``ops/devlevel.py`` accumulator a shard.  Digests combine
    commutatively, so folding shard by shard gives the value the per-chunk
    path's host folds give over the same rows."""
    from ..ops import devlevel

    for row in np.asarray(digests):
        chain.fold_digest(*devlevel.digest_ints(row.tolist()))
