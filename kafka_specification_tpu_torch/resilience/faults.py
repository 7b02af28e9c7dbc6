"""Deterministic fault injection (the `KSPEC_FAULT` grammar).

The port's own copy of ``kafka_specification_tpu/resilience/faults.py``.
It parses the JAX package's whole grammar, token for token, so a plan
means the same thing to both packages; the port's ``check()`` wires the
sites of the single-device engine and its disk tier, and refuses a plan
that names any other (``FaultPlan.unwired``), never ignoring it:

    crash@level:N          raise InjectedCrash at the level-N boundary
    crash@ckpt:N           raise InjectedCrash mid-checkpoint-write at
                           level N (tmp written, before the promote)
    crash@merge:N          raise InjectedCrash in the Nth disk-run merge of
                           this process (merged tmp written, before the
                           promote); N counts merges per process
    corrupt_ckpt           corrupt the newest checkpoint right after its
    corrupt_ckpt@ckpt:N    first write (or the write at level N)
    enospc@spill:N         OSError(ENOSPC) at the Nth spill-run write of
                           this process, before its promote
    enospc@merge:N         the same in the Nth disk-run merge
    enospc@ckpt:N          the same mid-checkpoint-write at level N
    enospc@plog:N          the same publishing the level-N parent-log segment
    stall@level:N          the level deadline watchdog reports level N stalled
    flip@frontier:N        flip one bit of the frontier at the level-N
                           boundary (a spilled frontier: bytes of its first
                           segment file)
    flip@fpset:N           flip one bit of the visited-set dump of the first
                           checkpoint past level N (caught before the write)
    flip@spill:N           flip bytes of the Nth spill-run file of this
                           process after its promote (caught by the run's
                           read-side CRC)
    flip@ckpt:N            flip the `levels` array of the first checkpoint
                           past level N before its CRC manifest is built
                           (caught by the post-save chain read-back)

Resource faults end in the typed RESOURCE_EXHAUSTED exit (75), bit flips
in INTEGRITY_VIOLATION (76), crashes in InjectedCrash and an exact resume.
Shard scopes (`crash@shard2:level:N`, `corrupt_ckpt@shard1`, ...) parse and,
in a single-device run, fire as their unscoped forms.

Crash faults fire only when the run *started* below the target level
(`set_start_depth`, called after a checkpoint resume), and on a
checkpointing run a `crash@level:N` defers until a checkpoint at or past
level N exists, so a restart resumes at or past the target and converges.
Per-process ordinals (`crash@merge`, `enospc@spill|merge`, `flip@spill`)
are for in-process tests: a restarted process counts from 1 again.
"""

from __future__ import annotations

import errno
import os
from dataclasses import dataclass
from typing import Optional

ENV_VAR = "KSPEC_FAULT"


class InjectedFault(RuntimeError):
    """Base class for all deliberately injected failures."""


class InjectedCrash(InjectedFault):
    """An injected hard crash (the process is expected to die)."""


#: kind -> valid sites (None = a bare fault) and grammar form, as in the
#: JAX package's registry
FAULT_REGISTRY = (
    ("crash", ("level", "ckpt", "merge", "daemon"),
     "crash@level|ckpt|merge:N | crash@daemon<i>:N"),
    ("corrupt_ckpt", ("ckpt",), "corrupt_ckpt[@ckpt:N]"),
    ("compile_oom", None, "compile_oom"),
    ("transient_device_err", None, "transient_device_err:N"),
    ("enospc", ("spill", "ckpt", "merge", "plog", "cache"),
     "enospc@spill|ckpt|merge|plog|cache:N"),
    ("stall", ("level", "daemon"), "stall@level:N | stall@daemon<i>"),
    ("flip", ("frontier", "fpset", "exchange", "spill", "ckpt", "cache"),
     "flip@frontier|fpset|exchange|spill|ckpt|cache:N"),
    ("kill", ("host",), "kill@host<i>:N"),
    ("partition", ("host",), "partition@host<i>[:N]"),
    ("skew", ("host",), "skew@host<i>:SECS"),
)

_SITES_BY_KIND = {k: sites for k, sites, _g in FAULT_REGISTRY}

#: the (kind, site) pairs the port's single-device check() wires
WIRED = frozenset({
    ("crash", "level"), ("crash", "ckpt"), ("crash", "merge"),
    ("corrupt_ckpt", "ckpt"),
    ("enospc", "spill"), ("enospc", "merge"), ("enospc", "ckpt"), ("enospc", "plog"),
    ("stall", "level"),
    ("flip", "frontier"), ("flip", "fpset"), ("flip", "spill"), ("flip", "ckpt"),
})


@dataclass
class _Spec:
    kind: str
    point: Optional[str]  # the site, or None for a bare fault
    arg: Optional[float]  # level/ordinal (int) or seconds (skew); None = first
    budget: int  # remaining firings
    shard: Optional[int] = None
    instance: Optional[int] = None  # serving-daemon scope
    host: Optional[int] = None  # service-host scope

    @property
    def site(self) -> str:
        return self.kind if self.point is None else f"{self.kind}@{self.point}"


def _split_shard(rest: str, tok: str):
    """Peel an optional `shard<d>:`/`shard<d>` scope off `rest`."""
    if not rest.startswith("shard"):
        return None, rest
    head, _, tail = rest.partition(":")
    try:
        shard = int(head[len("shard"):])
    except ValueError:
        raise ValueError(
            f"fault {tok!r}: shard scope must be 'shard<index>', got {head!r}"
        )
    if shard < 0:
        raise ValueError(f"fault {tok!r}: shard index must be >= 0")
    return shard, tail


def _int_arg(tok: str, arg: str, what: str) -> int:
    try:
        return int(arg)
    except ValueError:
        raise ValueError(f"fault {tok!r}: {what}")


def _parse_token(tok: str) -> _Spec:
    if "@" in tok:
        name, _, rest = tok.partition("@")
        shard, rest = _split_shard(rest, tok)
        if name == "corrupt_ckpt" and shard is not None and not rest:
            return _Spec("corrupt_ckpt", "ckpt", None, 1, shard)
        if name == "transient_device_err" and shard is not None:
            budget = _int_arg(tok, rest, "budget must be an integer") if rest else 1
            return _Spec("transient_device_err", None, None, budget, shard)
        if name == "compile_oom" and shard is not None and not rest:
            return _Spec("compile_oom", None, None, 1, shard)
        point, _, arg = rest.partition(":")
        if point.startswith("daemon") and name in ("crash", "stall"):
            inst = _int_arg(tok, point[len("daemon"):],
                            f"daemon scope must be 'daemon<index>', got {point!r}")
            if inst < 0:
                raise ValueError(f"fault {tok!r}: daemon index must be >= 0")
            if name == "stall":
                if arg:
                    raise ValueError(f"fault {tok!r}: stall@daemon<i> takes no ':N'")
                return _Spec("stall", "daemon", None, 1, instance=inst)
            nth = _int_arg(tok, arg, "crash@daemon<i>:N needs an integer job ordinal N")
            if nth < 1:
                raise ValueError(f"fault {tok!r}: job ordinal must be >= 1")
            return _Spec("crash", "daemon", nth, 1, instance=inst)
        if point.startswith("host") and name in ("kill", "partition", "skew"):
            host = _int_arg(tok, point[len("host"):],
                            f"host scope must be 'host<index>', got {point!r}")
            if host < 0:
                raise ValueError(f"fault {tok!r}: host index must be >= 0")
            if name == "kill":
                nth = _int_arg(tok, arg, "kill@host<i>:N needs an integer job ordinal N")
                if nth < 1:
                    raise ValueError(f"fault {tok!r}: job ordinal must be >= 1")
                return _Spec("kill", "host", nth, 1, host=host)
            if name == "partition":
                njobs = (_int_arg(tok, arg, "partition@host<i>:N needs an integer job count N")
                         if arg else 1)
                if njobs < 1:
                    raise ValueError(f"fault {tok!r}: job count must be >= 1")
                return _Spec("partition", "host", njobs, 1, host=host)
            try:
                secs = float(arg)
            except ValueError:
                raise ValueError(f"fault {tok!r}: skew@host<i>:SECS needs a number of seconds")
            if secs == 0.0:
                raise ValueError(f"fault {tok!r}: a zero skew rehearses nothing")
            return _Spec("skew", "host", secs, 1, host=host)
        if not arg:
            raise ValueError(f"fault {tok!r}: '@{point}' needs ':<level>'")
        level = _int_arg(tok, arg, "level must be an integer")
        if level < 1:
            # crash faults fire only when the run STARTED below the target
            # level, so level 0 could never fire: refuse it
            raise ValueError(f"fault {tok!r}: level must be >= 1")
        if name in _SITES_BY_KIND and _SITES_BY_KIND[name]:
            if point in _SITES_BY_KIND[name]:
                return _Spec(name, point, level, 1, shard)
            raise ValueError(
                f"fault {tok!r}: unknown site {point!r} for {name!r} "
                f"(valid sites: {', '.join(_SITES_BY_KIND[name])})"
            )
        raise ValueError(
            f"unknown fault {tok!r} (known kinds: "
            f"{', '.join(k for k, *_ in FAULT_REGISTRY)})"
        )
    name, _, count = tok.partition(":")
    if name == "corrupt_ckpt":
        if count:
            raise ValueError(f"fault {tok!r}: use corrupt_ckpt@ckpt:<level>")
        return _Spec("corrupt_ckpt", "ckpt", None, 1)
    if name == "compile_oom":
        return _Spec("compile_oom", None, None, int(count) if count else 1)
    if name == "transient_device_err":
        return _Spec("transient_device_err", None, None, int(count) if count else 1)
    raise ValueError(
        f"unknown fault {tok!r} (grammar: "
        + ", ".join(g for _k, _s, g in FAULT_REGISTRY) + ")"
    )


class FaultPlan:
    """A parsed set of faults plus their remaining budgets.

    The engine builds one per run with `FaultPlan.from_env()`; an unset
    env gives an empty plan whose hooks are all no-ops."""

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self.start_depth = 0
        self.specs = [_parse_token(t.strip()) for t in self.spec.split(",") if t.strip()]

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "FaultPlan":
        return cls(os.environ.get(env_var, ""))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def unwired(self) -> list:
        """The sites of this plan that the port's check() does not wire
        (it refuses the plan naming them)."""
        return sorted({s.site for s in self.specs if (s.kind, s.point) not in WIRED})

    def set_start_depth(self, depth: int) -> None:
        """Record the depth a resumed run starts from: crash faults at or
        below it are considered already-fired (restart convergence)."""
        self.start_depth = int(depth)

    def crash(self, point: str, depth: int, ckpt_depth=None) -> None:
        """Raise InjectedCrash if a crash fault matches this (point, depth).

        `ckpt_depth` (level boundaries only): the newest durably
        checkpointed level, or None when the run isn't checkpointing; a
        level crash defers until a checkpoint at or past its level exists,
        so a restart always resumes at or past it."""
        for s in self.specs:
            if s.kind != "crash" or s.point != point or s.budget <= 0:
                continue
            # merge ordinals are per-process counters, not BFS levels:
            # the resume-depth relief does not apply to them
            if point != "merge" and self.start_depth >= s.arg:
                continue  # resumed at/past the target: counts as fired
            if point == "level":
                if depth < s.arg:
                    continue
                if ckpt_depth is not None and ckpt_depth < s.arg:
                    continue  # not durably past the target yet: defer
            elif depth != s.arg:
                continue
            s.budget -= 1
            raise InjectedCrash(
                f"injected crash at {point}:{depth}"
                + (f" on shard {s.shard}" if s.shard is not None else "")
                + " (KSPEC_FAULT)"
            )

    def enospc(self, point: str, n: int) -> None:
        """Raise an injected OSError(ENOSPC) if an `enospc@<point>:N`
        fault matches.  `n` is the BFS level for ckpt/plog (resume-depth
        relief applies) and a per-process ordinal for spill/merge."""
        for s in self.specs:
            if s.kind != "enospc" or s.point != point or s.budget <= 0:
                continue
            if point in ("ckpt", "plog") and self.start_depth >= s.arg:
                continue  # resumed at/past the target: counts as fired
            if n != s.arg:
                continue
            s.budget -= 1
            raise OSError(
                errno.ENOSPC,
                f"No space left on device (injected by KSPEC_FAULT "
                f"enospc@{point}:{n})",
            )

    def stalled(self, depth: int) -> bool:
        """True once per `stall@level:N` fault when level N is done: the
        resource governor then reports the level as stalled.  Resume-depth
        relief applies."""
        for s in self.specs:
            if s.kind != "stall" or s.budget <= 0 or s.point == "daemon":
                continue
            if self.start_depth >= s.arg:
                continue
            if depth >= s.arg:
                s.budget -= 1
                return True
        return False

    def flip(self, site: str, n: int, ckpt_depth=None):
        """The matching `flip@<site>:N` spec (truthy), once per spec, else
        None; the caller then flips the bits at its site.  Level-keyed
        sites (frontier/fpset/ckpt): resume-depth relief applies, and with
        `ckpt_depth` given firing defers until a generation at or past N
        exists.  `spill`: `n` is a per-process ordinal."""
        for s in self.specs:
            if s.kind != "flip" or s.point != site or s.budget <= 0:
                continue
            if site == "spill":
                if n != s.arg:
                    continue
            else:
                if self.start_depth >= s.arg:
                    continue  # resumed at/past the target: counts as fired
                if n < s.arg:
                    continue
                if ckpt_depth is not None and ckpt_depth < s.arg:
                    continue  # not durably past the target yet: defer
            s.budget -= 1
            return s
        return None

    def should_corrupt(self, depth: int) -> bool:
        """True if the checkpoint just written at `depth` must be corrupted."""
        for s in self.specs:
            if s.kind == "corrupt_ckpt" and s.budget > 0:
                if s.arg is None or s.arg == depth:
                    s.budget -= 1
                    return True
        return False


def corrupt_file(path: str, n_bytes: int = 64) -> None:
    """Flip a run of bytes in the middle of `path` (simulated bit rot):
    inside an npz member's data, so both the zip CRC and the manifest
    checksums catch it on the next load."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(max(0, size // 2 - n_bytes // 2))
        chunk = fh.read(n_bytes)
        fh.seek(max(0, size // 2 - n_bytes // 2))
        fh.write(bytes(b ^ 0xFF for b in chunk))
