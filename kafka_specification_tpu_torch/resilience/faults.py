"""Deterministic fault injection (the `KSPEC_FAULT` grammar).

The port's own copy of ``kafka_specification_tpu/resilience/faults.py``.
It parses the JAX package's whole grammar, token for token, so a plan
means the same thing to both packages; the port wires the sites of the
single-device engine, its disk tier, the sharded engine, the serving
daemon and the routed fleet's hosts, and each engine refuses a plan that
names a site it does not wire (``FaultPlan.unwired``), never ignoring it:

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
    compile_oom            the next escalated chunk step (a `fused` chunk
                           above the compact gate, a device level) raises
                           an LLVM-OOM-shaped error once
    transient_device_err:N the next N chunk steps (a per-chunk dispatch, a
                           device level) raise a transient-classified
                           backend error
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
    flip@exchange:N        corrupt the received side of the sharded
                           engine's exchange framing digest at the first
                           chunk of level N (caught by the framing check);
                           the sharded engine only (``check_sharded``)

and the serving daemon's (``service/``), which its own ``$KSPEC_FAULT``
arms (a job's ``--fault`` plan reaches only that job's check()):

    enospc@cache:N         OSError(ENOSPC) at the Nth state-space-cache
                           publish of this process, before the entry's
                           promote (the publish aborts; the verdict stands)
    flip@cache:N           flip bytes of the Nth published cache artifact
                           of this process after its promote (the next
                           lookup rejects it and the job runs cold)
    crash@daemon<i>:N      InjectedCrash in daemon instance i before it
                           runs the group holding its Nth job (the claims
                           stay leased; the next janitor requeues them)
    stall@daemon<i>        daemon instance i wedges after its next claim
                           sweep (``serve --supervised`` kills it)

and the routed fleet's hosts (``service/router.py``: each host's daemons
run with ``KSPEC_HOST_INSTANCE=<i>``, so one composed plan drives a whole
multi-host drill, each fault firing only on its host):

    kill@host<i>:N         kill host i's daemon while it handles its Nth
                           job, before any verdict (durable once per
                           service dir, like crash@daemon)
    partition@host<i>[:N]  host i loses the shared state-cache namespace
                           for its next N jobs (default 1): lookups degrade
                           to typed cold runs, publishes are deferred and
                           re-published when the partition heals
    skew@host<i>:SECS      shift host i's wall clock by SECS (may be
                           negative) in the timestamps it writes where
                           other hosts read them (leases, heartbeats)

Resource faults end in the typed RESOURCE_EXHAUSTED exit (75), bit flips
in INTEGRITY_VIOLATION (76), crashes in InjectedCrash and an exact resume,
the two chunk faults in the retry ladder (``resilience/retry.py``): a
retry, or a degradation recorded in ``stats["degradations"]``.  They fire
before anything of the step is queued on the card, and are consumed in
process (a restarted process starts with its budget whole).
Shard scopes (`crash@shard2:level:N`, `corrupt_ckpt@shard1`, ...) fire, in
the sharded engine, only on the process that owns the shard
(``set_local_shards``), and a scope outside the mesh is refused
(``validate_shards``); in a single-device run they fire as their unscoped
forms.

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

# markers chosen so retry.classify() routes the injected error down the
# same branch a real backend error of that family would take
TRANSIENT_MARKER = "DATA_LOSS: injected transient device error (KSPEC_FAULT)"
OOM_MARKER = "LLVM ERROR: out of memory (injected by KSPEC_FAULT=compile_oom)"


class InjectedFault(RuntimeError):
    """Base class for all deliberately injected failures."""


class InjectedCrash(InjectedFault):
    """An injected hard crash (the process is expected to die)."""


#: the JAX package's registry, entry for entry: the parser validates
#: against it and `cli faults --list` renders it.
#: kind -> (valid sites (None = a bare fault), grammar form, description)
FAULT_REGISTRY = (
    ("crash", ("level", "ckpt", "merge", "daemon"),
     "crash@level|ckpt|merge:N | crash@daemon<i>:N",
     "raise InjectedCrash at the level-N boundary / mid-checkpoint-write "
     "(tmp written, pre-promote) / mid-way through the Nth disk-run merge; "
     "the daemon<i> form kills serving-daemon instance i while it handles "
     "its Nth job (claims stay leased; a sibling's janitor requeues them "
     "and the verdict still publishes exactly once — service/fleet.py).  "
     "Daemon-scoped faults fire once per SERVICE DIR (durable "
     "fired-marker), so a fleet-restarted daemon converges instead of "
     "crash-looping — the crash@level checkpoint-deferral rule's twin"),
    ("corrupt_ckpt", ("ckpt",), "corrupt_ckpt[@ckpt:N]",
     "corrupt the newest checkpoint right after its write (checksum-"
     "fallback rehearsal); bytes flipped AFTER the CRC manifest, so the "
     "zip/manifest checks catch it on load"),
    ("compile_oom", None, "compile_oom",
     "the next escalated chunk step raises an LLVM-OOM-shaped error once "
     "(degrades fused/adaptive paths to the uniform fallback)"),
    ("transient_device_err", None, "transient_device_err:N",
     "the next N chunk/exchange steps raise a transient-classified "
     "backend error (bounded-backoff retry rehearsal)"),
    ("enospc", ("spill", "ckpt", "merge", "plog", "cache"),
     "enospc@spill|ckpt|merge|plog|cache:N",
     "OSError(ENOSPC) at the writer's pre-promote point (typed "
     "RESOURCE_EXHAUSTED exit 75; state stays verifiable).  The cache "
     "site is the Nth state-space-cache publish of this process "
     "(service/state_cache.py): publication aborts cleanly with a "
     "cache-fallback event, the job's verdict is untouched"),
    ("stall", ("level", "daemon"), "stall@level:N | stall@daemon<i>",
     "the per-level deadline watchdog reports level N stalled (typed "
     "exit 75); the daemon<i> form wedges serving-daemon instance i "
     "after its next claim sweep — heartbeat and lease renewal freeze, "
     "so the fleet supervisor stall-kills it and a sibling's janitor "
     "takes its leased claims over at lease expiry"),
    ("flip", ("frontier", "fpset", "exchange", "spill", "ckpt", "cache"),
     "flip@frontier|fpset|exchange|spill|ckpt|cache:N",
     "silent bit-flip at the named state surface (typed "
     "INTEGRITY_VIOLATION exit 76; detected by the digest-chain / "
     "framing / read-side-CRC layer — resilience.integrity).  The cache "
     "site flips bytes in the Nth published state-space-cache artifact "
     "of this process AFTER its promote: the next lookup's chain/CRC "
     "verification rejects it with a cache-fallback event and the check "
     "degrades to a cold run — never a wrong verdict"),
    ("kill", ("host",), "kill@host<i>:N",
     "kill host i's serving daemon while it handles its Nth job, before "
     "any verdict is derived (the whole-host-death rehearsal of the "
     "routed fleet — service/router.py detects the stale heartbeats and "
     "re-routes the host's pending jobs; its leased claims come back via "
     "the janitor takeover protocol at lease expiry).  Fires once per "
     "SERVICE DIR (durable fired-marker), so a restarted host converges; "
     "hosts are scoped by KSPEC_HOST_INSTANCE, so one composed plan "
     "string drives a whole multi-host drill"),
    ("partition", ("host",), "partition@host<i>[:N]",
     "host i loses the shared state-space-cache namespace for its next N "
     "jobs (default 1): every lookup in the window degrades to a typed "
     "cache-fallback cold run (reason 'partition') and every publish is "
     "DEFERRED, then re-published when the partition heals — verdicts "
     "are untouched and the federation never serves a torn read.  "
     "Durable once per service dir, like kill@host"),
    ("skew", ("host",), "skew@host<i>:SECS",
     "shift host i's wall clock by SECS (float, may be negative) in "
     "every timestamp it writes into cross-host-visible metadata — "
     "claim-lease stamps and heartbeat records — rehearsing a fleet "
     "member with a drifted clock.  The KSPEC_CLOCK_SKEW allowance in "
     "lease expiry (service/queue.py) and router heartbeat freshness "
     "(service/router.py) is what keeps a skewed-but-live host's claims "
     "from being stolen; persistent for the process lifetime"),
)

_SITES_BY_KIND = {k: sites for k, sites, _g, _d in FAULT_REGISTRY}


def list_faults() -> list:
    """[{kind, grammar, description, scopeable}] for `cli faults --list`
    (every fault composes with a `shard<d>:` scope)."""
    return [
        {"kind": k, "grammar": g, "sites": list(sites or ()),
         "description": d, "scopeable": True}
        for k, sites, g, d in FAULT_REGISTRY
    ]

#: the (kind, site) pairs the port wires: its single-device check(), its
#: serving daemon and the routed fleet's hosts (the daemon, cache and host
#: sites, which check() ignores).  flip@exchange is the sharded engine's
#: (``WIRED_SHARDED``)
WIRED = frozenset({
    ("enospc", "cache"), ("flip", "cache"), ("crash", "daemon"), ("stall", "daemon"),
    ("kill", "host"), ("partition", "host"), ("skew", "host"),
    ("crash", "level"), ("crash", "ckpt"), ("crash", "merge"),
    ("corrupt_ckpt", "ckpt"),
    ("enospc", "spill"), ("enospc", "merge"), ("enospc", "ckpt"), ("enospc", "plog"),
    ("stall", "level"),
    ("transient_device_err", None), ("compile_oom", None),
    ("flip", "frontier"), ("flip", "fpset"), ("flip", "spill"), ("flip", "ckpt"),
})

#: the sharded engine's sites (``parallel/sharded.py``): the level, the
#: checkpoint and parent-log writes, the chunk step and the device level,
#: the disk tier's spills and merges, the governor's stall and the bit
#: flips, with its exchange; compile_oom fires on escalated attempts, which
#: are the device level's (the per-chunk step never escalates)
WIRED_SHARDED = frozenset({
    ("enospc", "cache"), ("flip", "cache"), ("crash", "daemon"), ("stall", "daemon"),
    ("kill", "host"), ("partition", "host"), ("skew", "host"),
    ("crash", "level"), ("crash", "ckpt"), ("crash", "merge"), ("corrupt_ckpt", "ckpt"),
    ("enospc", "spill"), ("enospc", "merge"), ("enospc", "ckpt"), ("enospc", "plog"),
    ("stall", "level"), ("transient_device_err", None), ("compile_oom", None),
    ("flip", "frontier"), ("flip", "fpset"), ("flip", "spill"), ("flip", "ckpt"),
    ("flip", "exchange"),
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
                f"(valid sites: {', '.join(_SITES_BY_KIND[name])}; "
                f"run `cli faults --list` for the full grammar)"
            )
        raise ValueError(
            f"unknown fault {tok!r} (known kinds: "
            f"{', '.join(k for k, *_ in FAULT_REGISTRY)}; run "
            f"`cli faults --list` for the full grammar)"
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
        + ", ".join(g for _k, _s, g, _d in FAULT_REGISTRY)
        + "; each '@'-scopeable as crash@shard<d>:level:N / "
        "corrupt_ckpt@shard<d> / transient_device_err@shard<d>:N; run "
        "`cli faults --list` for descriptions)"
    )


class FaultPlan:
    """A parsed set of faults plus their remaining budgets.

    The engine builds one per run with `FaultPlan.from_env()`; an unset
    env gives an empty plan whose hooks are all no-ops."""

    def __init__(self, spec: str = ""):
        self.spec = spec or ""
        self.start_depth = 0
        # which serving-daemon instance (set_instance) and service host
        # (set_host) this process is: daemon- and host-scoped faults fire
        # only on an exact match, so None never fires them
        self.instance: Optional[int] = None
        self.host: Optional[int] = None
        # the shards this process owns (set_local_shards; None: every one)
        self.local_shards: Optional[frozenset] = None
        self.specs = [_parse_token(t.strip()) for t in self.spec.split(",") if t.strip()]

    @classmethod
    def from_env(cls, env_var: str = ENV_VAR) -> "FaultPlan":
        return cls(os.environ.get(env_var, ""))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def unwired(self, wired=WIRED) -> list:
        """The sites of this plan outside `wired` (the engine's set:
        ``WIRED`` for check(), ``WIRED_SHARDED`` for check_sharded()); the
        engine refuses a plan naming any."""
        return sorted({s.site for s in self.specs if (s.kind, s.point) not in wired})

    def set_local_shards(self, shards) -> None:
        """Record which shards this process owns (the sharded engine's
        mesh): a shard-scoped fault then fires only on the owner of its
        shard; the peers pass the injection point and wait in their next
        collective, the one-process-died failure a fleet supervisor
        catches."""
        self.local_shards = frozenset(int(s) for s in shards)

    def validate_shards(self, shard_count: int) -> None:
        """Refuse shard scopes outside the mesh: a typo'd
        `crash@shard5:...` on a 2-shard run would otherwise rehearse
        nothing on every process and report the drill as passed."""
        for s in self.specs:
            if s.shard is not None and s.shard >= shard_count:
                raise ValueError(
                    f"fault plan {self.spec!r}: shard {s.shard} is out of "
                    f"range for a {shard_count}-shard mesh (valid: "
                    f"0..{shard_count - 1})"
                )

    def _is_local(self, s: _Spec) -> bool:
        return s.shard is None or self.local_shards is None or s.shard in self.local_shards

    def set_instance(self, instance: int) -> None:
        """Record which serving-daemon instance this process is
        (``crash@daemon<i>``/``stall@daemon<i>`` fire only in instance i)."""
        self.instance = int(instance)

    def set_host(self, host: int) -> None:
        """Record which service host this process serves (the router's
        per-host daemons run with ``KSPEC_HOST_INSTANCE=i``):
        ``kill@host<i>``, ``partition@host<i>`` and ``skew@host<i>`` fire
        only in host i's processes."""
        self.host = int(host)

    def _host_match(self, s: _Spec) -> bool:
        return s.host is not None and self.host is not None and s.host == self.host

    def host_kill(self, lo: int, hi: Optional[int] = None) -> None:
        """Raise InjectedCrash if a `kill@host<i>:N` fault targets this host
        and job ordinal N is in [lo, hi]: the daemon's hook, beside
        `daemon_crash`, before any verdict.  The router sees the host's
        heartbeats go stale and re-routes its pending jobs; leased claims
        come back through the takeover, so the verdict publishes once."""
        hi = lo if hi is None else hi
        for s in self.specs:
            if s.kind != "kill" or s.budget <= 0 or not self._host_match(s):
                continue
            if not lo <= s.arg <= hi:
                continue
            s.budget -= 1
            raise InjectedCrash(
                f"injected host kill on host {s.host} at job ordinal "
                f"{int(s.arg)} (KSPEC_FAULT)"
            )

    def daemon_crash(self, lo: int, hi: Optional[int] = None) -> None:
        """Raise InjectedCrash if a `crash@daemon<i>:N` fault targets this
        instance and job ordinal N is in [lo, hi] (the 1-based ordinals of
        the group the daemon is about to run), before any verdict of it."""
        hi = lo if hi is None else hi
        for s in self.specs:
            if s.kind != "crash" or s.point != "daemon" or s.budget <= 0:
                continue
            if s.instance != self.instance or not lo <= s.arg <= hi:
                continue
            s.budget -= 1
            raise InjectedCrash(
                f"injected daemon crash on instance {s.instance} at job "
                f"ordinal {s.arg} (KSPEC_FAULT)"
            )

    def daemon_stalled(self) -> bool:
        """True once per `stall@daemon<i>` fault targeting this instance."""
        for s in self.specs:
            if (s.kind == "stall" and s.point == "daemon" and s.budget > 0
                    and s.instance == self.instance):
                s.budget -= 1
                return True
        return False

    def host_partition(self) -> int:
        """Jobs this host must run cache-partitioned, once per
        `partition@host<i>[:N]` fault targeting it, then 0.  The daemon
        consumes it at a claim sweep: for that many jobs every state-cache
        lookup degrades to a typed `cache-fallback` cold run and every
        publish is deferred, re-published on heal."""
        for s in self.specs:
            if s.kind == "partition" and s.budget > 0 and self._host_match(s):
                s.budget -= 1
                return int(s.arg)
        return 0

    def skew_s(self) -> float:
        """The wall-clock shift of this host's cross-host-visible stamps;
        0.0 without a matching `skew@host<i>:SECS`.  Never consumed: a
        drifted clock drifts for the whole process lifetime."""
        return sum(float(s.arg) for s in self.specs
                   if s.kind == "skew" and self._host_match(s))

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
            if not self._is_local(s):
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
        relief applies) and a per-process ordinal for spill/merge/cache."""
        for s in self.specs:
            if s.kind != "enospc" or s.point != point or s.budget <= 0:
                continue
            if not self._is_local(s):
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
            if not self._is_local(s):
                continue
            if self.start_depth >= s.arg:
                continue
            if depth >= s.arg:
                s.budget -= 1
                return True
        return False

    def chunk_error(self, escalated: bool) -> Optional[Exception]:
        """Error to inject into the next chunk step, or None.

        compile_oom fires only on escalated attempts, matching the real
        failure mode it rehearses and the only attempt shape for which
        the engine has a fallback."""
        for s in self.specs:
            if not self._is_local(s):
                continue
            if s.kind == "transient_device_err" and s.budget > 0:
                s.budget -= 1
                return RuntimeError(TRANSIENT_MARKER)
            if s.kind == "compile_oom" and s.budget > 0 and escalated:
                s.budget -= 1
                return RuntimeError(OOM_MARKER)
        return None

    def flip(self, site: str, n: int, ckpt_depth=None):
        """The matching `flip@<site>:N` spec (truthy; it carries the shard
        scope, so the sharded engine flips the targeted shard's buffer),
        once per spec, else None; the caller then flips the bits at its
        site (for `exchange`, the received framing digest).  Level-keyed
        sites (frontier/fpset/ckpt): resume-depth relief applies, and with
        `ckpt_depth` given firing defers until a generation at or past N
        exists.  `spill` and `cache`: `n` is a per-process ordinal."""
        for s in self.specs:
            if s.kind != "flip" or s.point != site or s.budget <= 0:
                continue
            if not self._is_local(s):
                continue
            if site in ("spill", "cache"):
                # per-process ordinals: the Nth spill run, the Nth
                # state-space-cache artifact published
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
            if s.kind == "corrupt_ckpt" and s.budget > 0 and self._is_local(s):
                if s.arg is None or s.arg == depth:
                    s.budget -= 1
                    return True
        return False


#: injected_skew_s's cache: (KSPEC_FAULT, KSPEC_HOST_INSTANCE) -> seconds.
#: The lease stamp calls it on every renewal; the pair is fixed for a
#: process's life and varies only across monkeypatched tests.
_SKEW_CACHE: dict = {}


def injected_skew_s() -> float:
    """The wall-clock shift (seconds) that `skew@host<i>:SECS` injects into
    the timestamps this process writes where other hosts read them (claim
    leases, heartbeats, fleet-trace stamps): 0.0 unless KSPEC_FAULT holds a
    skew fault for this process's KSPEC_HOST_INSTANCE.  Never raises (an
    unparseable plan is the engine's or the CLI's error to report)."""
    key = (os.environ.get(ENV_VAR, ""), os.environ.get("KSPEC_HOST_INSTANCE", ""))
    if key not in _SKEW_CACHE:
        skew = 0.0
        if key[0] and key[1]:
            try:
                plan = FaultPlan(key[0])
                plan.set_host(int(key[1]))
                skew = plan.skew_s()
            except (ValueError, TypeError):
                skew = 0.0
        _SKEW_CACHE[key] = skew
    return _SKEW_CACHE[key]


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
