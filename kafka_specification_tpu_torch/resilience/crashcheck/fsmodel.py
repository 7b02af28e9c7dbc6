"""Legal post-crash filesystem states from a recorded durable-op trace.

ALICE-style model (PAPERS.md; the crash-consistency literature's core
observation): a crash does not leave "the filesystem as of the last
op" — it leaves any state the filesystem was *permitted* to persist.
The permissions this model grants, per op of the ``durable_io``
vocabulary:

- ``write`` with ``fsynced=False``: the file's *data* is independent of
  every directory operation — it may persist empty, as a prefix, or as
  a prefix plus a garbage block (a torn sector), no matter how much
  later the crash happens.  ``fsynced=True`` data is durable the moment
  the op is recorded (recording happens after the fsync returned), but
  a crash *during* the write is modeled at the preceding prefix as a
  partial application of the upcoming op.
- ``rename``/``unlink``: directory-entry ops are durable only once a
  ``fsync_dir`` of the affected directory follows them.  An un-fsynced
  rename may revert wholesale (the missing-dir-fsync case this harness
  exists to make observable: the file is back at the source name, the
  destination shows its pre-rename content) or half-persist with the
  source entry lingering next to the destination (both names reach the
  moved content — what ``sweep_tmp`` exists to collect).  An un-fsynced
  unlink may simply not have happened.
- ``append``: journal tails are never fsync'd; the final record on each
  path may be dropped entirely or torn mid-record.

Enumeration is bounded, not exhaustive: at every prefix of the op-log
we emit the clean state plus one state per (vulnerable op, degradation
mode) over a recent-ops window, plus a pairwise combination of the two
newest vulnerabilities (the classic "rename reverted AND data torn"
compound).  States are deduplicated by tree digest across the whole
scenario, so the reported count is of *distinct* filesystem states.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field

#: torn-write garbage block: what a sector-torn write leaves after the
#: valid prefix (0xff bytes make JSON/zip/CRC readers fail loudly, the
#: adversarial case — a silent-prefix tear is covered separately)
_GARBAGE = b"\xff" * 8

#: how many of the most recent vulnerable ops get degraded per prefix
_VULN_WINDOW = 6

#: hard cap of degraded states emitted per prefix (clean state excluded)
_MAX_PER_PREFIX = 14


def snapshot_tree(root: str):
    """(files: {relpath: bytes}, dirs: [relpath]) under ``root``."""
    files, dirs = {}, []
    root = os.path.abspath(root)
    for cur, dns, fns in os.walk(root):
        rel = os.path.relpath(cur, root).replace(os.sep, "/")
        if rel != ".":
            dirs.append(rel)
        for fn in fns:
            p = os.path.join(cur, fn)
            with open(p, "rb") as fh:
                files[(rel + "/" + fn) if rel != "." else fn] = fh.read()
    return files, sorted(dirs)


def _dirname(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else "."


def replay(base: dict, ops: list, n: int, transforms=None) -> dict:
    """Apply ``ops[:n]`` to a copy of ``base``; ``transforms`` maps an op
    index to a degradation: ``("skip",)`` (the op never persisted),
    ``("linger",)`` (rename persisted but the source entry survived too),
    or ``("data", bytes)`` (the op's payload persisted torn)."""
    transforms = transforms or {}
    tree = dict(base)
    for idx in range(n):
        op = ops[idx]
        t = transforms.get(idx)
        kind = op["op"]
        if t is not None and t[0] == "skip":
            continue
        if kind == "write":
            data = t[1] if t is not None and t[0] == "data" else op["data"]
            tree[op["path"]] = data
        elif kind == "append":
            data = t[1] if t is not None and t[0] == "data" else op["data"]
            tree[op["path"]] = tree.get(op["path"], b"") + data
        elif kind == "rename":
            src, dst = op["src"], op["dst"]
            if src in tree:
                tree[dst] = tree[src]
                if t is None or t[0] != "linger":
                    del tree[src]
        elif kind == "unlink":
            tree.pop(op["path"], None)
        # fsync_dir / ack: no tree effect
    return tree


def _vulnerable(ops: list, n: int) -> list:
    """[(op_index, mode)] of legal degradations at prefix ``n``, newest
    first.  ``mode``: "skip" | "linger" | "data" | "tail"."""
    def synced_after(j: int, d: str) -> bool:
        return any(
            ops[k]["op"] == "fsync_dir" and ops[k]["path"] == d
            for k in range(j + 1, n)
        )

    out = []
    last_append = {}
    for j in range(n):
        op = ops[j]
        kind = op["op"]
        if kind == "rename":
            dd, sd = _dirname(op["dst"]), _dirname(op["src"])
            if not synced_after(j, dd):
                out.append((j, "skip"))
                out.append((j, "linger"))
            elif not synced_after(j, sd):
                # destination entry is durable but the source removal may
                # not be (cross-directory rename fsyncing only the
                # destination — the queue's claim rename)
                out.append((j, "linger"))
        elif kind == "unlink":
            if not synced_after(j, _dirname(op["path"])):
                out.append((j, "skip"))
        elif kind == "write":
            if not op.get("fsynced"):
                out.append((j, "data"))
        elif kind == "append":
            last_append[op["path"]] = j
    out.extend((j, "tail") for j in last_append.values())
    out.sort(key=lambda it: -it[0])
    return out[:_VULN_WINDOW]


def _data_variants(data: bytes) -> list:
    """Torn-content variants of a payload, coarsest first."""
    variants = [b""]
    if len(data) > 1:
        variants.append(data[: len(data) // 2])
        variants.append(data[: len(data) - 1] + _GARBAGE)
    return variants


def _transforms_for(ops, idx, mode) -> list:
    """Concrete transform dicts for one (op, degradation-mode) pair."""
    op = ops[idx]
    if mode in ("skip", "linger"):
        return [{idx: (mode,)}]
    if mode == "data":
        return [{idx: ("data", v)} for v in _data_variants(op["data"])]
    if mode == "tail":  # last journal record on this path: lost or torn
        out = [{idx: ("skip",)}]
        data = op["data"]
        if len(data) > 1:
            out.append({idx: ("data", data[: len(data) // 2])})
        return out
    raise AssertionError(mode)


@dataclass
class CrashState:
    """One materializable post-crash state plus its machine repro."""

    prefix: int  # ops[:prefix] were issued before the crash
    degraded: list  # [[op_index, mode-string], ...]
    tree: dict = field(repr=False)  # relpath -> bytes

    def digest(self) -> str:
        h = hashlib.sha256()
        for path in sorted(self.tree):
            h.update(path.encode())
            h.update(b"\0")
            h.update(hashlib.sha256(self.tree[path]).digest())
        return h.hexdigest()[:16]


def enumerate_crash_states(base: dict, ops: list) -> list:
    """Every distinct :class:`CrashState` over every prefix of ``ops``."""
    states, seen = [], set()

    def add(prefix, transforms):
        tree = replay(base, ops, prefix, transforms)
        st = CrashState(
            prefix=prefix,
            degraded=[[i, "+".join(str(p) for p in t)]
                      for i, t in sorted(transforms.items())],
            tree=tree,
        )
        d = st.digest()
        if d not in seen:
            seen.add(d)
            states.append(st)
            return True
        return False

    for n in range(len(ops) + 1):
        add(n, {})
        emitted = 0
        vuln = _vulnerable(ops, n)
        for idx, mode in vuln:
            for tf in _transforms_for(ops, idx, mode):
                if emitted >= _MAX_PER_PREFIX:
                    break
                if add(n, tf):
                    emitted += 1
        # pairwise compound of the two newest vulnerabilities (rename
        # reverted AND the data it moved torn — the ALICE classic)
        if len(vuln) >= 2 and emitted < _MAX_PER_PREFIX:
            tf = {}
            for idx, mode in vuln[:2]:
                if idx not in tf:
                    tf.update(_transforms_for(ops, idx, mode)[0])
            if len(tf) == 2:
                add(n, tf)
        # a crash DURING the next op: partial application of ops[n]
        # (this is how a crash mid-``fsynced=True`` write is reachable —
        # the op itself is only ever recorded after its fsync returned)
        if n < len(ops) and ops[n]["op"] in ("write", "append"):
            for v in _data_variants(ops[n]["data"]):
                add(n + 1, {n: ("data", v)})
    return states


def materialize(state: CrashState, dirs: list, dest: str,
                age_s: float = 3600.0) -> None:
    """Write ``state`` into ``dest`` as a real tree.  Every mtime is
    backdated by ``age_s`` so recovery-side grace windows (the leaseless
    claim window, grace-aged tmp sweeps, cache GC) see the crash
    artifacts as the old files they would be at real recovery time."""
    os.makedirs(dest, exist_ok=True)
    for d in dirs:
        os.makedirs(os.path.join(dest, d), exist_ok=True)
    old = time.time() - age_s
    for rel, data in state.tree.items():
        p = os.path.join(dest, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fh:
            fh.write(data)
        os.utime(p, (old, old))
    for cur, _dns, _fns in os.walk(dest):
        os.utime(cur, (old, old))


def summarize_ops(ops: list) -> list:
    """JSON-safe op-log (payload bytes replaced by length + digest) —
    the machine-readable half of a finding's repro."""
    out = []
    for op in ops:
        rec = {}
        for k, v in op.items():
            if isinstance(v, bytes):
                rec[k] = {
                    "len": len(v),
                    "sha256": hashlib.sha256(v).hexdigest()[:16],
                }
            else:
                rec[k] = v
        out.append(rec)
    return out
