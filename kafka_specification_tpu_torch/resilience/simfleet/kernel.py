"""The simulation kernel: real control-plane code, simulated schedule.

One :class:`SimKernel` run drives REAL ``JobQueue``/``Router``/
``StateSpaceCache`` instances (plus a stub-engine daemon actor) inside
one process, under the virtual :class:`~.simclock.SimClock` and a
recorded schedule of discrete steps.  Determinism is total per
(seed, config): time only moves when the kernel moves it, every random
draw comes from the run's own seeded RNG (including the queue's
transient-retry jitter, patched in for the run), actor identity
(pid/claim-token) is virtual and kernel-assigned, and filesystem faults
fire from a deterministic budget through the ``durable_io`` fault hook.

Yield-point inventory (what a schedule step can interleave):

``advance``         pure time advance (the scheduler's `dt` riding every
                    step is the fine-grained version)
``client_submit``   one `Router.submit` of the next job
``daemon_claim``    one `JobQueue.claim_pending(limit=1)` on a host
``daemon_finish``   complete the earliest-due running job: cache lookup,
                    stub verdict, cache publish, `JobQueue.finish`
``daemon_hb``       busy-heartbeat: `renew_leases` + heartbeat append
``daemon_janitor``  `JobQueue.requeue_orphans` (startup/periodic janitor)
``router_sweep``    one full `Router.sweep`
``kill``            daemon process death (claims + leases left behind)
``restart``         daemon restart: new generation, pid, token, and the
                    production startup janitor
``partition``       host unreachable: its daemon stops stepping (and
                    renewing) but its pid stays alive — the exact
                    scenario claim leases exist for
``heal``            partition ends; the daemon resumes mid-thought
``skew``            set a host's wall-clock offset (within the
                    configured allowance)
``flaky_fs``        arm the next-K durable fs ops to fail EIO (through
                    `durable_io.set_fault_hook`, exercising every
                    `retry_transient` envelope in virtual time)

After the schedule, the kernel heals all faults and runs a fixed
deterministic drain protocol; the oracles (`oracles.py`) judge every
step and the final state.  The event log is pure data — same seed,
bit-identical log.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import tempfile
from dataclasses import asdict, dataclass
from typing import Optional

from ... import durable_io as _dio
from ...utils import clock as _clock
from .. import heartbeat as _hb
from . import oracles as _oracles
from .simclock import SIM_EPOCH, SimClock

#: per-step time advances the generator draws from (seconds, weight) —
#: a mix of "same instant", "momentarily later", and jumps that cross
#: the heartbeat-freshness and lease-TTL horizons
DT_CHOICES = (
    (0.0, 4), (0.05, 4), (0.5, 4), (2.0, 4), (7.0, 3), (15.0, 2),
    (40.0, 1),
)

#: stub-engine execution durations a claim step can draw
DURATION_CHOICES = (0.1, 1.0, 5.0, 20.0)

#: host skew offsets a skew step can draw — all within the default
#: allowance (DEFAULT_CLOCK_SKEW_S = 5.0), including the exact boundary
SKEW_CHOICES = (-5.0, -4.999, -1.0, 0.0, 1.0, 4.999, 5.0)

#: how many consecutive durable fs ops a flaky_fs step poisons
FLAKY_CHOICES = (1, 2, 3, 6)

_ACTION_WEIGHTS = (
    ("advance", 16),
    ("client_submit", 10),
    ("daemon_claim", 12),
    ("daemon_finish", 14),
    ("daemon_hb", 12),
    ("daemon_janitor", 6),
    ("router_sweep", 8),
    ("kill", 2),
    ("restart", 5),
    ("partition", 2),
    ("heal", 5),
    ("skew", 2),
    ("flaky_fs", 2),
)

_MODULES = ("SimRegistry", "SimBroker")

MAX_DRAIN_ROUNDS = 48
_DRAIN_RESTART_ROUND = 16


@dataclass
class SimConfig:
    """Knobs of one simulated fleet.  Sim-scale defaults: a lease TTL of
    minutes would need minutes of virtual time per takeover scenario."""

    hosts: int = 2
    jobs: int = 4
    steps: int = 60
    lease_ttl: float = 30.0
    dead_after_s: float = 20.0
    skew_allowance_s: float = 5.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        return cls(**{k: d[k] for k in asdict(cls()) if k in d})


class _Daemon:
    """One daemon incarnation on a host (a restart makes a new one)."""

    def __init__(self, host: int, gen: int, queue):
        self.host = host
        self.gen = gen
        self.pid = 100000 + host * 1000 + gen
        self.token = f"simtok-{host}-{gen:02d}"
        self.queue = queue
        self.alive = True
        self.connected = True
        # job_id -> {"finish_at": true-time, "spec": dict}
        self.running: dict = {}


class _Host:
    def __init__(self, index: int, service_dir: str):
        self.index = index
        self.dir = service_dir
        self.skew = 0.0
        self.gen = 0
        self.daemon: Optional[_Daemon] = None


class SimKernel:
    """One deterministic run.  Generation mode draws steps from a seeded
    RNG and records them; replay mode consumes a given schedule (entries
    that no longer apply no-op, which is what makes ddmin subsets
    runnable).  Either way the drain phase and the oracles are fixed and
    rng-free."""

    def __init__(self, config: SimConfig, root: Optional[str] = None):
        self.cfg = config
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="simfleet-")
        self.clock = SimClock(SIM_EPOCH)
        self.events: list = []
        self.violations: list = []
        self.schedule: list = []
        self.flaky_remaining = 0
        self.next_job = 0
        self.submitted: list = []
        # oracle bookkeeping (ground truth, kernel-side)
        self.claims: dict = {}       # job -> lease/owner bookkeeping
        self.running_by: dict = {}   # job -> set of (host, gen)
        self.hosts: list = []
        self.router = None
        self.cache = None
        self._alive_pids: set = set()
        self._rng = None
        self._restores: list = []

    # --- environment install/teardown ----------------------------------

    def _install(self, seed: int) -> None:
        from ...service import queue as qmod
        from ...service import router as rmod
        from ...service import state_cache as scmod

        prev_clock = _clock.install(self.clock)
        self._restores.append(lambda: _clock.install(prev_clock))

        real_getpid = os.getpid
        self._restores.append(lambda: setattr(os, "getpid", real_getpid))

        real_alive_q = qmod._pid_alive
        real_alive_r = rmod._pid_alive
        alive = self._alive_pids

        def sim_pid_alive(pid: int) -> bool:
            return pid in alive

        qmod._pid_alive = sim_pid_alive
        rmod._pid_alive = sim_pid_alive
        self._restores.append(
            lambda: (setattr(qmod, "_pid_alive", real_alive_q),
                     setattr(rmod, "_pid_alive", real_alive_r)))

        real_token = qmod._PROC_TOKEN
        self._restores.append(
            lambda: setattr(qmod, "_PROC_TOKEN", real_token))

        # the queue's transient-retry jitter draws virtual SLEEPS; an
        # unseeded module RNG would make virtual time itself
        # nondeterministic, so the run gets its own
        real_retry_rng = qmod._RETRY_RNG
        qmod._RETRY_RNG = random.Random(seed ^ 0x5EED)
        self._restores.append(
            lambda: setattr(qmod, "_RETRY_RNG", real_retry_rng))

        prev_hook = _dio.set_fault_hook(self._fault_hook)
        self._restores.append(lambda: _dio.set_fault_hook(prev_hook))

        prev_env = os.environ.get("KSPEC_HOST_INSTANCE")

        def restore_env():
            if prev_env is None:
                os.environ.pop("KSPEC_HOST_INSTANCE", None)
            else:
                os.environ["KSPEC_HOST_INSTANCE"] = prev_env

        self._restores.append(restore_env)

        host_dirs = []
        for i in range(self.cfg.hosts):
            d = os.path.join(self.root, f"host{i}")
            h = _Host(i, d)
            self.hosts.append(h)
            host_dirs.append(d)
        self._as_actor(None)  # router identity while constructing
        self.router = rmod.Router(
            os.path.join(self.root, "router"), hosts=host_dirs,
            dead_after_s=self.cfg.dead_after_s,
            skew_s=self.cfg.skew_allowance_s,
        )
        self.cache = scmod.StateSpaceCache(os.path.join(self.root, "sc"))
        for h in self.hosts:
            self._spawn_daemon(h, startup_janitor=False)

    def _teardown(self) -> None:
        while self._restores:
            self._restores.pop()()
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def _fault_hook(self, op: str, path: str) -> None:
        if self.flaky_remaining > 0:
            self.flaky_remaining -= 1
            raise OSError(5, f"simfleet flaky-fs injected EIO ({op})")

    # --- actor identity -------------------------------------------------

    def _as_actor(self, host: Optional[int]) -> None:
        """Point process-visible identity (pid, claim token, wall-clock
        offset, trace clock domain) at the acting component: a host's
        daemon, or the router/client plane (``None``, unskewed)."""
        from ...service import queue as qmod

        if host is None:
            os.getpid = lambda: 99999
            qmod._PROC_TOKEN = "simtok-router"
            self.clock.offset = 0.0
            os.environ["KSPEC_HOST_INSTANCE"] = "router"
        else:
            h = self.hosts[host]
            d = h.daemon
            os.getpid = (lambda pid=d.pid: pid)
            qmod._PROC_TOKEN = d.token
            self.clock.offset = h.skew
            os.environ["KSPEC_HOST_INSTANCE"] = f"host{host}"

    def _spawn_daemon(self, h: _Host, startup_janitor: bool = True):
        from ...service import queue as qmod

        if h.daemon is not None:
            self._alive_pids.discard(h.daemon.pid)
            h.daemon.alive = False
        h.gen += 1
        d = _Daemon(h.index, h.gen,
                    qmod.JobQueue(h.dir, skew_s=self.cfg.skew_allowance_s))
        h.daemon = d
        self._alive_pids.add(d.pid)
        if startup_janitor:
            self._as_actor(h.index)
            moved = self._safe(lambda: d.queue.requeue_orphans(
                lease_ttl=self.cfg.lease_ttl,
                skew_s=self.cfg.skew_allowance_s)) or []
            _oracles.check_takeover(self, sorted(moved),
                                    by=f"startup-janitor:host{h.index}")
            return sorted(moved)
        return []

    @staticmethod
    def _safe(fn):
        """Production callers tolerate transient OSErrors around these
        protocols; the sim does the same so an injected EIO degrades a
        step instead of crashing the kernel."""
        try:
            return fn()
        except OSError:
            return None

    # --- the job stub ----------------------------------------------------

    def _module_for(self, n: int) -> str:
        return _MODULES[n % len(_MODULES)]

    def _stub_verdict(self, module: str) -> dict:
        counts = [1, 3, 5] if module == _MODULES[0] else [2, 4]
        return {
            "model": module, "distinct_states": sum(counts),
            "diameter": 2, "levels": counts, "violation": None,
            "exit_code": 0, "states_per_sec": 1.0, "seconds": 0.1,
        }

    def _cache_key(self, module: str):
        from ...service import state_cache as sc

        return sc.CacheKey(module, False,
                           (("MaxId", 2 + _MODULES.index(module)),),
                           ("TypeOk",), (), False, max_depth=2)

    def _cache_rows(self, module: str):
        import numpy as np

        rng = np.random.RandomState(1 + _MODULES.index(module))
        counts = self._stub_verdict(module)["levels"]
        return [rng.randint(0, 50, size=(n, 2)).astype(np.uint32)
                for n in counts]

    # --- step execution --------------------------------------------------

    def _eligible(self, action: str) -> list:
        """Hosts (or [None] for hostless actions) the action applies to
        right now; empty = inapplicable."""
        alive_conn = [h.index for h in self.hosts
                      if h.daemon.alive and h.daemon.connected]
        if action in ("daemon_claim", "daemon_hb", "daemon_janitor"):
            return alive_conn
        if action == "daemon_finish":
            return [i for i in alive_conn
                    if self.hosts[i].daemon.running]
        if action == "kill":
            return [h.index for h in self.hosts if h.daemon.alive]
        if action == "restart":
            return [h.index for h in self.hosts if not h.daemon.alive]
        if action == "partition":
            return [h.index for h in self.hosts
                    if h.daemon.alive and h.daemon.connected]
        if action == "heal":
            return [h.index for h in self.hosts
                    if h.daemon.alive and not h.daemon.connected]
        if action == "skew":
            return [h.index for h in self.hosts]
        if action == "client_submit":
            return [None] if self.next_job < self.cfg.jobs else []
        if action in ("advance", "router_sweep", "flaky_fs"):
            return [None]
        raise ValueError(f"unknown action {action!r}")

    def _perform(self, action: str, host, extra):
        """Execute one applicable step; returns the event `out` dict."""
        if action == "advance":
            return {}
        if action == "flaky_fs":
            self.flaky_remaining += int(extra or 1)
            return {"armed": self.flaky_remaining}
        if action == "skew":
            self.hosts[host].skew = float(extra or 0.0)
            return {"skew": self.hosts[host].skew}
        if action == "kill":
            h = self.hosts[host]
            d = h.daemon
            d.alive = False
            d.connected = False
            self._alive_pids.discard(d.pid)
            aborted = sorted(d.running)
            for jid in aborted:
                self.running_by.get(jid, set()).discard((host, d.gen))
            d.running.clear()
            return {"aborted": aborted}
        if action == "restart":
            moved = self._spawn_daemon(self.hosts[host])
            return {"gen": self.hosts[host].gen, "janitor_moved": moved}
        if action == "partition":
            self.hosts[host].daemon.connected = False
            return {}
        if action == "heal":
            self.hosts[host].daemon.connected = True
            return {}
        if action == "client_submit":
            return self._step_submit()
        if action == "daemon_claim":
            return self._step_claim(host, float(extra or 1.0))
        if action == "daemon_finish":
            return self._step_finish(host)
        if action == "daemon_hb":
            return self._step_hb(host)
        if action == "daemon_janitor":
            return self._step_janitor(host)
        if action == "router_sweep":
            return self._step_sweep()
        raise ValueError(f"unknown action {action!r}")

    def _step_submit(self) -> dict:
        self._as_actor(None)
        jid = f"job-{self.next_job:04d}"
        module = self._module_for(self.next_job)
        try:
            spec = self.router.submit(
                "sim cfg", module, tenant="sim", kernel_source="hand",
                job_id=jid,
            )
            out = {"job": jid, "host": spec["host"]}
        except OSError as e:
            # the client saw the submit fail; only count the job as in
            # flight if the spec actually landed somewhere
            landed = any(
                os.path.isfile(h.daemon.queue._job_path(st, jid))
                for h in self.hosts for st in ("pending", "claimed"))
            if not landed:
                return {"job": jid, "failed": f"EIO:{e.errno}"}
            out = {"job": jid, "host": None, "partial": True}
        self.submitted.append(jid)
        self.next_job += 1
        return out

    def _step_claim(self, host: int, duration: float) -> dict:
        self._as_actor(host)
        d = self.hosts[host].daemon
        specs = d.queue.claim_pending(limit=1) or []
        out = {"claimed": []}
        for spec in specs:
            jid = spec["job_id"]
            out["claimed"].append(jid)
            existing = self._safe(lambda: d.queue.result(jid))
            if existing is not None:
                # the production daemon's short-circuit: terminal truth
                # already on disk — retire, never re-run
                self._safe(lambda: d.queue.finish(jid, existing))
                out["short_circuit"] = jid
                continue
            _oracles.check_claim(self, jid, host)
            d.running[jid] = {
                "finish_at": self.clock.t + duration,
                "module": spec["module"],
            }
            self.running_by.setdefault(jid, set()).add((host, d.gen))
            self._note_lease(jid, host)
        return out

    def _note_lease(self, jid: str, host: int) -> None:
        d = self.hosts[host].daemon
        if not os.path.isfile(d.queue._job_path("claimed", jid)):
            # the claim was taken over (a legitimacy already judged at
            # the takeover site): the old executor renewing a DANGLING
            # lease does not re-acquire the claim, so it must not
            # refresh the ownership bookkeeping either
            return
        lease = d.queue.read_lease(jid)
        self.claims[jid] = {
            "host": host, "gen": d.gen,
            "renewed_true": self.clock.t,
            "landed": bool(lease and lease.get("token") == d.token),
        }

    def _step_finish(self, host: int) -> dict:
        self._as_actor(host)
        d = self.hosts[host].daemon
        due = sorted(
            (v["finish_at"], j) for j, v in d.running.items()
            if v["finish_at"] <= self.clock.t
        )
        if not due:
            return {"due": 0}
        jid = due[0][1]
        module = d.running[jid]["module"]
        verdict = dict(self._stub_verdict(module))
        key = self._cache_key(module)
        hit = _oracles.check_cache_lookup(self, jid, module, key)
        if hit is None:
            try:
                self.cache.publish(
                    key, self._stub_verdict(module), exact64=True,
                    lanes=2, level_rows=self._cache_rows(module),
                    diameter=2)
                published = True
            except OSError:
                published = False
        else:
            published = False
        verdict["job_id"] = jid
        try:
            d.queue.finish(jid, verdict)
        except OSError as e:
            # verdict publish failed (flaky fs): the job stays running
            # and a later finish step retries — production's supervisor
            # retry, compressed
            return {"job": jid, "finish_failed": f"EIO:{e.errno}"}
        del d.running[jid]
        self.running_by.get(jid, set()).discard((host, d.gen))
        return {"job": jid, "cache": "hit" if hit else "miss",
                "published": published}

    def _step_hb(self, host: int) -> dict:
        self._as_actor(host)
        d = self.hosts[host].daemon
        jobs = sorted(d.running)
        self._safe(lambda: d.queue.renew_leases(jobs))
        for jid in jobs:
            self._note_lease(jid, host)
        try:
            _hb.append_jsonl(
                os.path.join(self.hosts[host].dir, "heartbeat-sim.jsonl"),
                _hb.heartbeat_record("daemon", pid=d.pid, state="busy"
                                     if jobs else "idle"),
            )
            landed = True
        except OSError:
            landed = False
        return {"renewed": jobs, "hb": landed}

    def _step_janitor(self, host: int) -> dict:
        self._as_actor(host)
        d = self.hosts[host].daemon
        moved = self._safe(lambda: d.queue.requeue_orphans(
            lease_ttl=self.cfg.lease_ttl,
            skew_s=self.cfg.skew_allowance_s)) or []
        moved = sorted(moved)
        _oracles.check_takeover(self, moved, by=f"janitor:host{host}")
        return {"moved": moved}

    def _step_sweep(self) -> dict:
        self._as_actor(None)
        out = self._safe(self.router.sweep)
        if out is None:
            return {"failed": "EIO"}
        for hid, moved in sorted(out.get("takeover", {}).items()):
            _oracles.check_takeover(self, sorted(moved),
                                    by=f"sweep:host{hid}")
        return {
            "states": [h["state"] for h in out["hosts"]],
            "takeover": {str(k): sorted(v)
                         for k, v in sorted(out["takeover"].items())},
            "rerouted": {str(k): sorted(v)
                         for k, v in sorted(out["rerouted"].items())},
        }

    # --- run loop ---------------------------------------------------------

    def _record_event(self, i, action, host, extra, dt, out) -> None:
        self.events.append({
            "i": i, "t": round(self.clock.t, 3), "a": action,
            "h": host, "x": extra, "dt": dt, "out": out,
        })

    def _run_step(self, i: int, entry: dict) -> None:
        action, host = entry["a"], entry.get("h")
        extra, dt = entry.get("x"), float(entry.get("dt", 0.0))
        self.clock.offset = 0.0
        self.clock.advance(dt)
        eligible = self._eligible(action)
        if not eligible or (host is not None and host not in eligible):
            out = {"skipped": True}
        else:
            out = self._perform(action, host, extra)
        self.clock.offset = 0.0
        self._record_event(i, action, host, extra, dt, out)
        _oracles.check_copies(self, step=i)

    def _gen_entry(self, rng: random.Random) -> dict:
        dts, dtw = zip(*DT_CHOICES)
        dt = rng.choices(dts, weights=dtw)[0]
        acts, actw = zip(*_ACTION_WEIGHTS)
        while True:
            action = rng.choices(acts, weights=actw)[0]
            eligible = self._eligible(action)
            if eligible:
                break
        host = rng.choice(eligible)
        extra = None
        if action == "daemon_claim":
            extra = rng.choice(DURATION_CHOICES)
        elif action == "skew":
            extra = rng.choice(SKEW_CHOICES)
        elif action == "flaky_fs":
            extra = rng.choice(FLAKY_CHOICES)
        return {"a": action, "h": host, "x": extra, "dt": dt}

    def _drain(self) -> bool:
        """Deterministic rng-free cool-down: heal every fault, then run
        fixed rounds of the full control loop until every submitted job
        has a routed verdict.  A mid-drain rolling restart (idle daemons
        only) releases any protocol-private files a live pid still pins
        — production's rolling-restart recovery, compressed."""
        self.flaky_remaining = 0
        for h in self.hosts:
            if h.daemon.alive:
                h.daemon.connected = True
        for r in range(MAX_DRAIN_ROUNDS):
            if self._drained():
                return True
            if r == _DRAIN_RESTART_ROUND:
                for h in self.hosts:
                    if h.daemon.alive and not h.daemon.running:
                        self._spawn_daemon(h)
            for h in self.hosts:
                if not h.daemon.alive:
                    self._spawn_daemon(h)
                self._step_hb(h.index)
                while self._step_finish(h.index).get("due", 1) != 0:
                    pass
                self._step_claim(h.index, 1.0)
            for h in self.hosts:
                self._step_janitor(h.index)
            self._step_sweep()
            self.clock.offset = 0.0
            self.clock.advance(5.0)
            _oracles.check_copies(self, step=-1 - r)
        return self._drained()

    def _drained(self) -> bool:
        self._as_actor(None)
        for jid in self.submitted:
            if self._safe(lambda: self.router.result(jid)) is None:
                return False
        return True

    def run(self, seed: Optional[int] = None,
            schedule: Optional[list] = None) -> dict:
        """Generation mode (``seed`` alone) or replay mode (``schedule``
        given; ``seed`` then only feeds the retry-jitter RNG, so a repro
        carries its original seed alongside its schedule).  Returns the
        run record; the kernel's ``root`` (host/router/trace dirs)
        survives until the caller tears it down via :meth:`cleanup`."""
        if seed is None and schedule is None:
            raise ValueError("need a seed or a schedule")
        eff_seed = seed if seed is not None else 0
        self._install(eff_seed)
        try:
            if schedule is None:
                rng = random.Random(seed)
                for i in range(self.cfg.steps):
                    entry = self._gen_entry(rng)
                    self.schedule.append(entry)
                    self._run_step(i, entry)
            else:
                self.schedule = [dict(e) for e in schedule]
                for i, entry in enumerate(self.schedule):
                    self._run_step(i, entry)
            drained = self._drain()
            _oracles.check_final(self, drained)
            verdicts = self._final_verdicts()
        finally:
            os.environ.pop("KSPEC_HOST_INSTANCE", None)
            self._teardown_patches()
        record = {
            "schema": "kspec-simfleet-run/1",
            "seed": seed,
            "config": self.cfg.to_dict(),
            "schedule": self.schedule,
            "events": self.events,
            "verdicts": verdicts,
            "violations": self.violations,
            "drained": drained,
        }
        record["digest"] = run_digest(record)
        return record

    def _final_verdicts(self) -> dict:
        self._as_actor(None)
        out = {}
        for jid in sorted(self.submitted):
            v = self._safe(lambda: self.router.result(jid))
            out[jid] = (None if v is None else
                        {"exit_code": v.get("exit_code"),
                         "distinct_states": v.get("distinct_states"),
                         "model": v.get("model")})
        return out

    def _teardown_patches(self) -> None:
        # split from root cleanup so replay callers can keep the root
        # (for --trace) while identity/clock patches are long restored
        while self._restores:
            self._restores.pop()()

    def cleanup(self) -> None:
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def trace_roots(self) -> list:
        return [h.dir for h in self.hosts] + [self.router.dir]


def run_digest(record: dict) -> str:
    """The determinism surface: events + verdicts + violations + drain,
    canonically serialized.  Same seed ⇒ same digest, bit for bit."""
    surface = {
        "events": record["events"],
        "verdicts": record["verdicts"],
        "violations": record["violations"],
        "drained": record["drained"],
    }
    blob = json.dumps(surface, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def run_seed(seed: int, config: Optional[SimConfig] = None,
             root: Optional[str] = None, keep: bool = False) -> dict:
    """One generation-mode run; cleans its workdir unless ``keep``."""
    k = SimKernel(config or SimConfig(), root=root)
    try:
        return k.run(seed=seed)
    finally:
        if not keep:
            k.cleanup()


def run_schedule(schedule: list, config: Optional[SimConfig] = None,
                 seed: int = 0, root: Optional[str] = None,
                 keep: bool = False):
    """One replay-mode run; returns (record, kernel) — the kernel keeps
    its root alive when ``keep`` so callers can assemble fleet traces."""
    k = SimKernel(config or SimConfig(), root=root)
    try:
        rec = k.run(seed=seed, schedule=schedule)
        return rec, k
    finally:
        if not keep:
            k.cleanup()
