"""Cross-host router: one submit surface over N per-host service dirs.

The port's own copy of ``kafka_specification_tpu/service/router.py``: its
records (``router.json``, route records, events) are the JAX package's,
so either package's router fronts either package's hosts.  The fleet
(``service/fleet.py``) makes ONE host survivable (supervised daemons,
lease takeover, chain-verified state cache); this module is the layer
above it: a torch-free router that fronts N per-host queue directories — real
hosts, or isolated container "hosts" that share nothing but the
federated state-cache namespace — and gives tenants a single
submit/status/result surface with:

- **health-aware placement**: each host's daemons already append
  heartbeat records (``service/heartbeat*.jsonl``); the router reads the
  newest record's ``unix`` stamp (through ``retry_transient`` — the
  heartbeat files live on the same flaky network mounts as everything
  else) and treats a host as DEAD once that stamp is stale past
  ``dead_after_s`` plus the ``KSPEC_CLOCK_SKEW`` allowance.  Timestamps
  written by another host's clock are never compared raw.
- **depth-aware placement**: among routable hosts, submits go to the
  smallest backlog (pending + claimed), index-stable on ties.
- **per-tenant admission**: the router dir carries its own
  ``tenants.json`` (resilience.resources budget machinery); a tenant's
  ``max_pending`` is enforced against the SUM of its pending jobs across
  every fronted host — the fleet-wide cap the per-host check cannot see.
- **dead-host re-route, exactly once**: a sweep over a dead host first
  runs the host queue's own janitor (``requeue_orphans`` — expired /
  dead-pid leases return to pending THROUGH the existing takeover
  protocol, attribution stamps included), then moves each pending job to
  a survivor via a rename-private / stamp / publish / unlink protocol
  that mirrors the janitor's: exactly one router wins the private
  rename, the intended target is durably recorded INSIDE the private
  file before the copy, and a router that dies mid-protocol is adopted
  by a later sweep (re-published if the copy never landed, retired if it
  did).  A job whose verdict already exists is never re-routed — a
  published verdict is terminal wherever its spec sits.

Death is only ever declared on evidence: a host that has NEVER
heartbeat-ed is "unseen" (its daemons may still be booting — jobs queue
and wait), not dead.  The host-state taxonomy (`classify_host`) mirrors
resilience.supervisor.classify_exit: ok | unseen | dead.

State under the router dir::

    <router>/router.json            {schema, hosts, dead_after_s, ...}
    <router>/routes/<job_id>.json   placement record + reroute history
    <router>/tenants.json           fleet-wide tenant budgets
    <router>/events.jsonl           route/sweep/reroute events
    <router>/router-heartbeat.jsonl the router's own liveness trail

Torch-free: the router runs on a box that never pays the torch import,
the same contract as the queue clients it fronts.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .. import durable_io as _dio
from ..obs import fleettrace
from ..obs.atomicio import atomic_write_json
from ..resilience.heartbeat import append_jsonl, heartbeat_record
from ..utils import clock as _clk
from ..resilience.resources import budget_for_tenant, load_tenant_budgets
from .queue import (
    CLAIMED,
    DONE,
    PENDING,
    JobQueue,
    _pid_alive,
    clock_skew_s,
    retry_transient,
)

ROUTER_SCHEMA = "kspec-router/1"

#: default seconds of heartbeat silence before a host reads as dead
#: (plus the KSPEC_CLOCK_SKEW allowance; must exceed the daemons' idle
#: heartbeat cadence with margin, or an idle fleet reads as a dead one)
DEFAULT_DEAD_AFTER_S = 30.0

#: sticky batch-affinity release threshold: a module stays on its
#: affinity host until that host's backlog exceeds the least-loaded
#: routable host's by this many jobs.  Keeping a module co-located lets
#: the daemon claim one large batched group (one envelope exploration,
#: one compile-cache entry) instead of paying the group's fixed cost
#: per host — the Kafka sticky-partitioner economics, applied to
#: placement; the slack bounds the imbalance a hot module can cause
AFFINITY_SLACK_JOBS = 64


class AdmissionDenied(RuntimeError):
    """Fleet-wide tenant budget exceeded (`cli submit --router` exit 2)."""

    def __init__(self, tenant: str, cap: int, pending: int):
        self.tenant, self.cap, self.pending = tenant, cap, pending
        super().__init__(
            f"tenant {tenant!r} at max_pending cap {cap} "
            f"({pending} pending across the fleet)"
        )


def classify_host(seen: bool, alive: bool) -> str:
    """Host-state taxonomy, the cross-host row of the failure table
    — mirrors resilience.supervisor.classify_exit:

    - ``ok``: fresh heartbeats — routable, jobs flow.
    - ``unseen``: no heartbeat EVER — routable (daemons may be booting;
      death needs evidence), deprioritized behind live hosts.
    - ``dead``: heartbeats went stale past the skew-tolerant threshold —
      not routable; pending re-routed, claimed taken over at lease
      expiry."""
    if not seen:
        return "unseen"
    return "ok" if alive else "dead"


class Router:
    """The torch-free cross-host front.  Construct with ``hosts`` to
    create/refresh the router dir, or without to open an existing one."""

    def __init__(self, router_dir: str, hosts: Optional[list] = None,
                 dead_after_s: Optional[float] = None,
                 skew_s: Optional[float] = None):
        # explicit skew pin (None = the KSPEC_CLOCK_SKEW env default):
        # threads through every heartbeat-freshness decision AND down
        # into the fronted queues' lease-expiry math — the harness-safe
        # alternative to mutating the process-global env var
        self.skew_s = skew_s
        self.dir = os.path.normpath(router_dir)
        self.routes_dir = os.path.join(self.dir, "routes")
        self.config_path = os.path.join(self.dir, "router.json")
        self.tenants_path = os.path.join(self.dir, "tenants.json")
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self.heartbeat_path = os.path.join(
            self.dir, "router-heartbeat.jsonl"
        )
        cfg = self._load_config()
        if hosts is None:
            if cfg is None:
                raise FileNotFoundError(
                    f"{self.config_path}: not a router dir (create one "
                    "with `cli route <dir> --hosts <svc0> <svc1> ...`)"
                )
            hosts = cfg["hosts"]
        if dead_after_s is None:
            dead_after_s = (
                float(cfg["dead_after_s"]) if cfg else DEFAULT_DEAD_AFTER_S
            )
        self.hosts = [os.path.normpath(h) for h in hosts]
        if not self.hosts:
            raise ValueError("router needs at least one host service dir")
        self.dead_after_s = float(dead_after_s)
        # module -> host sticky-batching hint (in-memory: a routing
        # efficiency, not a correctness property — concurrent routers
        # converge per-router, and a restart just re-sticks)
        self._affinity = {}
        os.makedirs(self.routes_dir, exist_ok=True)
        # startup-janitor parity (crashcheck `router` scenario): a route
        # writer killed mid-atomic-write leaves a nonce'd `.tmp` here;
        # routes are multi-writer (every router instance), so grace-aged
        _dio.sweep_tmp(self.routes_dir, min_age_s=_dio.TMP_SWEEP_GRACE_S)
        self.queues = [JobQueue(h, skew_s=skew_s) for h in self.hosts]
        if cfg is None or cfg.get("hosts") != self.hosts or (
            float(cfg.get("dead_after_s", -1.0)) != self.dead_after_s
        ):
            atomic_write_json(
                self.config_path,
                {
                    "schema": ROUTER_SCHEMA,
                    "hosts": self.hosts,
                    "dead_after_s": self.dead_after_s,
                    "created_unix": (
                        cfg.get("created_unix") if cfg
                        else round(_clk.now(), 3)
                    ),
                },
            )

    def _load_config(self) -> Optional[dict]:
        try:
            with open(self.config_path) as fh:
                cfg = json.load(fh)
        except (OSError, ValueError):
            return None
        if cfg.get("schema") != ROUTER_SCHEMA:
            raise ValueError(
                f"{self.config_path}: schema {cfg.get('schema')!r} is not "
                f"{ROUTER_SCHEMA} (version skew: upgrade the router CLI "
                "or recreate the dir)"
            )
        return cfg

    # --- telemetry --------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        try:
            append_jsonl(
                self.events_path,
                heartbeat_record("router", event=kind, **fields),
            )
        except OSError:
            pass  # telemetry must never take the router down

    # --- health -----------------------------------------------------------
    def _newest_heartbeat_unix(self, host: int) -> Optional[float]:
        """Newest heartbeat `unix` stamp across the host's daemons, read
        through retry_transient; None = no heartbeat has ever landed.
        The JSON `unix` field, not file mtime, is what the skew fault
        (skew@host<i>) shifts and the skew allowance defends — mtime
        would silently use the FILESYSTEM's clock and dodge the drill."""
        svc = self.queues[host].service_dir

        def scan():
            newest = None
            try:
                names = os.listdir(svc)
            except FileNotFoundError:
                return None
            for name in names:
                if not (
                    name.startswith("heartbeat")
                    and name.endswith(".jsonl")
                ):
                    continue
                path = os.path.join(svc, name)
                try:
                    with open(path, "rb") as fh:
                        fh.seek(0, os.SEEK_END)
                        size = fh.tell()
                        fh.seek(max(0, size - 8192))
                        lines = fh.read().splitlines()
                except FileNotFoundError:
                    continue
                stamp = None
                for ln in reversed(lines):
                    try:
                        stamp = float(json.loads(ln)["unix"])
                        break
                    except (ValueError, KeyError, TypeError):
                        continue  # torn tail line: try the one before
                if stamp is None:
                    continue
                newest = stamp if newest is None else max(newest, stamp)
            return newest

        try:
            return retry_transient(scan)
        except OSError:
            return None

    def host_health(self, host: int) -> dict:
        """One host's routable-state snapshot (see `classify_host`)."""
        q = self.queues[host]
        hb = self._newest_heartbeat_unix(host)
        now = _clk.now()
        seen = hb is not None
        # the heartbeat stamp came from ANOTHER host's clock: the
        # staleness window widens by the skew allowance, so a live host
        # running a few seconds behind is never declared dead
        alive = bool(
            seen
            and (now - hb) <= self.dead_after_s + clock_skew_s(self.skew_s)
        )
        return {
            "host": host,
            "dir": q.dir,
            "state": classify_host(seen, alive),
            "hb_age_s": round(now - hb, 3) if seen else None,
            "pending": q.pending_count(),
            "claimed": q.claimed_count(),
        }

    def healths(self) -> list:
        return [self.host_health(i) for i in range(len(self.queues))]

    # --- placement --------------------------------------------------------
    def _choose_host(self, healths: list, module: str = None) -> int:
        """Placement among routable hosts: live hosts first, never-seen
        hosts (booting daemons) as the fallback, and only when EVERY
        host is dead does placement fall back to all of them — a queued
        job on a dead host beats a rejected submit, and the sweep
        re-routes it the moment anything comes back.

        Within the pool: same-module submits STICK to their module's
        host (sticky batch affinity — the daemons batch same-shape
        pending jobs into one engine group, so co-locating a module
        buys one group run instead of one per host), released to the
        least-loaded host when the affinity host falls
        AFFINITY_SLACK_JOBS behind it or leaves the pool."""
        for pool_state in (("ok",), ("unseen",), ("ok", "unseen", "dead")):
            pool = [h for h in healths if h["state"] in pool_state]
            if not pool:
                continue
            least = min(
                pool,
                key=lambda h: (h["pending"] + h["claimed"], h["host"]),
            )
            sticky = self._affinity.get(module)
            if sticky is not None:
                for h in pool:
                    if h["host"] != sticky:
                        continue
                    lag = (h["pending"] + h["claimed"]) - (
                        least["pending"] + least["claimed"]
                    )
                    if lag <= AFFINITY_SLACK_JOBS:
                        return sticky
                    break  # too far behind: re-stick below
            if module is not None:
                self._affinity[module] = least["host"]
            return least["host"]
        raise ValueError("router has no hosts")  # unreachable: len >= 1

    def _check_admission(self, tenant: str) -> None:
        try:
            budgets = load_tenant_budgets(self.tenants_path)
        except ValueError:
            raise  # a malformed governance config must fail the submit
        budget = budget_for_tenant(budgets, tenant)
        cap = budget.max_pending if budget is not None else None
        if cap is None:
            return
        total = 0
        for q in self.queues:
            total += q.pending_for_tenant(tenant, stop_at=cap - total)
            if total >= cap:
                raise AdmissionDenied(tenant, cap, total)

    def submit(self, cfg_text: str, module: str, tenant: str = "default",
               host: Optional[int] = None, **kw) -> dict:
        """Route one submit: fleet-wide admission, health + depth
        placement (or an explicit ``host`` pin — the operator escape
        hatch), then the chosen host queue's own atomic submit.  Returns
        the published spec with ``spec['host']`` set."""
        t_place = fleettrace.now()
        self._check_admission(tenant)
        pinned = host is not None
        if host is None:
            host = self._choose_host(self.healths(), module=module)
        elif not (0 <= host < len(self.queues)):
            raise ValueError(
                f"host {host} out of range (0..{len(self.queues) - 1})"
            )
        spec = self.queues[host].submit(
            cfg_text, module, tenant=tenant, **kw
        )
        self._write_route(spec["job_id"], host, why="submit")
        self._event(
            "route-submit", job=spec["job_id"], host=host, tenant=tenant,
        )
        # placement span lands under the ROUTER dir: the router is its
        # own clock domain, and `cli trace` unions it with the hosts'
        fleettrace.emit_span(
            self.dir, spec.get("trace"), "route-place",
            t_place, fleettrace.now(), job_id=spec["job_id"],
            to_host=host, why="pinned" if pinned else "health",
        )
        spec["host"] = host
        return spec

    # --- route records ----------------------------------------------------
    def _route_path(self, job_id: str) -> str:
        return os.path.join(self.routes_dir, f"{job_id}.json")

    def _write_route(self, job_id: str, host: int, why: str) -> None:
        rec = self.read_route(job_id) or {
            "schema": ROUTER_SCHEMA,
            "job_id": job_id,
            "history": [],
        }
        rec["host"] = host
        rec["dir"] = self.hosts[host]
        rec["history"].append(
            {"host": host, "why": why, "at": round(_clk.now(), 3)}
        )
        try:
            atomic_write_json(
                self._route_path(job_id), rec,
                # route records race ACROSS router instances to the same
                # final path: a shared `.tmp` name would let one racer
                # promote/unlink the sibling's half-written tmp —
                # privatise it
                tmp_nonce=f"{os.getpid():x}-{os.urandom(4).hex()}",
            )
        except OSError:
            pass  # resolution falls back to the all-hosts scan

    def read_route(self, job_id: str) -> Optional[dict]:
        try:
            with open(self._route_path(job_id)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def locate(self, job_id: str) -> Optional[int]:
        """Best-effort host index for a job: the route record when it
        exists, else a scan of every host (a job submitted around the
        router, or a record lost to a full disk, still resolves)."""
        rec = self.read_route(job_id)
        if rec is not None:
            host = rec.get("host")
            if isinstance(host, int) and 0 <= host < len(self.queues):
                return host
        for i, q in enumerate(self.queues):
            if q.result(job_id) is not None:
                return i
            if any(
                q._isfile(q._job_path(st, job_id))
                for st in (PENDING, CLAIMED, DONE)
            ):
                return i
        return None

    def status(self, job_id: str) -> dict:
        host = self.locate(job_id)
        if host is None:
            return {"job_id": job_id, "state": "unknown", "host": None}
        out = self.queues[host].status(job_id)
        out["host"] = host
        return out

    def result(self, job_id: str) -> Optional[dict]:
        """The verdict, wherever it landed.  The routed host is checked
        first, but a verdict is accepted from ANY host: a re-route that
        lost its record update still resolves (verdicts are
        deterministic and published exactly once, so whichever dir holds
        it is the answer)."""
        host = self.locate(job_id)
        if host is not None:
            rec = self.queues[host].result(job_id)
            if rec is not None:
                return rec
        for q in self.queues:
            rec = q.result(job_id)
            if rec is not None:
                return rec
        return None

    def wait_result(self, job_id: str, timeout: float = 120.0,
                    poll: float = 0.05) -> Optional[dict]:
        deadline = _clk.monotonic() + timeout
        while True:
            rec = self.result(job_id)
            if rec is not None:
                return rec
            if _clk.monotonic() >= deadline:
                return None
            _clk.sleep(poll)

    def overview(self) -> dict:
        try:
            routes = len(os.listdir(self.routes_dir))
        except OSError:
            routes = 0
        return {
            "dir": self.dir,
            "dead_after_s": self.dead_after_s,
            "clock_skew_s": clock_skew_s(self.skew_s),
            "routes": routes,
            "hosts": self.healths(),
        }

    # --- the sweep (health scan + dead-host recovery) ---------------------
    def sweep(self) -> dict:
        """One router pass: adopt any dead router's half-done re-routes,
        then for every DEAD host run its queue's own janitor (leased
        claims return through the takeover protocol at lease expiry) and
        re-route its pending jobs to survivors.  Idempotent; safe to run
        from several routers at once (every move is an atomic rename
        exactly one actor wins)."""
        self._adopt_stale_reroutes()
        healths = self.healths()
        survivors = [h["host"] for h in healths if h["state"] == "ok"]
        out = {"hosts": healths, "takeover": {}, "rerouted": {}}
        for h in healths:
            if h["state"] != "dead":
                continue
            q = self.queues[h["host"]]
            try:
                moved = q.requeue_orphans(skew_s=self.skew_s)
            except OSError:
                moved = []
            if moved:
                out["takeover"][h["host"]] = sorted(moved)
                self._event(
                    "host-takeover", host=h["host"], jobs=sorted(moved),
                )
            if survivors:
                rerouted = self._reroute_pending(h["host"], survivors)
                if rerouted:
                    out["rerouted"][h["host"]] = rerouted
            elif q.pending_count():
                self._event("reroute-stranded", host=h["host"])
        try:
            append_jsonl(
                self.heartbeat_path,
                heartbeat_record(
                    "router-heartbeat",
                    pid=os.getpid(),
                    hosts={
                        str(h["host"]): h["state"] for h in healths
                    },
                ),
            )
        except OSError:
            pass
        return out

    def _reroute_pending(self, dead: int, survivors: list) -> list:
        """Move a dead host's pending jobs to survivors, exactly once.

        Per job: (1) atomically rename the pending spec to a
        router-private name — one actor wins; (2) stamp the re-route
        attribution INCLUDING the intended target into the private file
        (durable intent: adoption after a router death knows where the
        copy was headed); (3) publish into the target's pending/ (plus
        its tenant admission marker); (4) unlink the private file and
        update the route record.  A job whose verdict already published
        is retired in place, never re-run."""
        q = self.queues[dead]
        depths = {
            s: self.queues[s].pending_count()
            + self.queues[s].claimed_count()
            for s in survivors
        }
        moved = []
        for job_id in sorted(q._list(PENDING)):
            if q.result(job_id) is not None:
                # terminal truth already on disk (daemon died between
                # verdict write and claim retire, then got requeued):
                # retire the spec so nobody ever re-runs it
                try:
                    _dio.rename(
                        q._job_path(PENDING, job_id),
                        q._job_path(DONE, job_id),
                    )
                except OSError:
                    pass
                continue
            target = min(survivors, key=lambda s: (depths[s], s))
            src = q._job_path(PENDING, job_id)
            private = src + f".reroute-{os.getpid()}"
            try:
                _dio.rename(src, private)
            except OSError:
                continue  # claimed / another router won: not ours
            try:
                with open(private) as fh:
                    spec = json.load(fh)
                spec.setdefault("reroutes", []).append(
                    {
                        "from_host": dead,
                        "to_host": target,
                        "by_pid": os.getpid(),
                        "reason": "host-dead",
                        "at": round(_clk.now(), 3),
                    }
                )
                atomic_write_json(private, spec)
                tq = self.queues[target]
                tdir = tq._tenant_dir(spec.get("tenant", "default"))
                os.makedirs(tdir, exist_ok=True)
                _dio.write_text(os.path.join(tdir, job_id), "")
                atomic_write_json(tq._job_path(PENDING, job_id), spec)
            except (OSError, ValueError):
                # cannot complete the move: put the job back where one
                # actor-at-a-time recovery can retry it
                try:
                    _dio.rename(private, src)
                except OSError:
                    pass
                continue
            try:
                _dio.unlink(private)
            except OSError:
                pass  # adoption retires it once this pid is gone
            self._write_route(job_id, target, why="reroute:host-dead")
            self._event(
                "route-reroute", job=job_id, from_host=dead,
                to_host=target,
            )
            # the re-route is a typed annotation on the job's ONE trace
            # (the context rode inside the spec), never a gap in it
            fleettrace.emit_event(
                self.dir, spec.get("trace"), "route-reroute",
                job_id=job_id, from_host=dead, to_host=target,
                reason="host-dead",
            )
            depths[target] += 1
            moved.append(job_id)
        return moved

    def _adopt_stale_reroutes(self) -> None:
        """Recovery sweep for the re-route protocol: a router that died
        mid-move leaves `pending/<id>.json.reroute-<pid>`.  Once that
        pid is dead, the stamped intent decides: if the job already
        exists at the recorded target (the copy landed), the private
        file is retired; otherwise it returns to pending for the next
        sweep to move — either way, exactly one runnable copy."""
        for q in self.queues:
            try:
                names = os.listdir(os.path.join(q.queue_dir, PENDING))
            except OSError:
                continue
            for name in names:
                if ".json.reroute-" not in name:
                    continue
                job_id, _, pid_s = name.rpartition(".reroute-")
                job_id = job_id[: -len(".json")]
                try:
                    if _pid_alive(int(pid_s)):
                        continue  # that router is mid-protocol
                except ValueError:
                    continue
                path = os.path.join(q.queue_dir, PENDING, name)
                target = None
                try:
                    with open(path) as fh:
                        stamps = json.load(fh).get("reroutes") or []
                    if stamps:
                        target = stamps[-1].get("to_host")
                except (OSError, ValueError):
                    pass
                landed = False
                if isinstance(target, int) and 0 <= target < len(
                    self.queues
                ):
                    tq = self.queues[target]
                    landed = tq.result(job_id) is not None or any(
                        os.path.isfile(tq._job_path(st, job_id))
                        for st in (PENDING, CLAIMED, DONE)
                    )
                try:
                    if landed:
                        _dio.unlink(path)
                    else:
                        _dio.rename(path, q._job_path(PENDING, job_id))
                except OSError:
                    pass

    def serve(self, poll_s: float = 1.0,
              max_sweeps: Optional[int] = None) -> None:
        """The blocking router loop (``cli route``): sweep, sleep,
        repeat.  `max_sweeps` bounds it for tests and `--once`."""
        n = 0
        self._stop = False
        while not getattr(self, "_stop", False):
            self.sweep()
            n += 1
            if max_sweeps is not None and n >= max_sweeps:
                return
            _clk.sleep(poll_s)

    def request_stop(self) -> None:
        self._stop = True
