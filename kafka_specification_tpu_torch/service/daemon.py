"""The serving daemon: ``cli serve`` — a warm, multi-tenant check runner.

The port's own copy of ``kafka_specification_tpu/service/daemon.py``.  One
process imports torch ONCE, takes the card, builds the CUDA kernels at
their first launch, then drains the durable job queue:

    claim pending jobs -> state-space cache (hit: the verdict, no run;
        delta: a seed) -> plan groups (scheduler) -> for each group:
        model-cache lookup (shape-keyed model + PreparedKernels)
        one engine run on the card (batched: one exploration serves the
        whole group; solo: check(), seeded when the cache gave a seed)
        per-job verdict files + per-job obs run dirs

The daemon runs on the card unless ``ServeConfig.device`` says "cpu"; on a
machine without CUDA it refuses to start (``Daemon`` raises before any
claim), never answering jobs with error verdicts and never falling back to
the CPU.  Its own ``$KSPEC_FAULT`` arms the daemon, cache and host faults
(``crash@daemon<i>:N``, ``stall@daemon<i>``, ``flip@cache:N``,
``enospc@cache:N``, ``kill@host<i>:N``, ``partition@host<i>[:N]``,
``skew@host<i>:SECS``); a plan naming an unwired site (``flip@exchange``)
is refused at start.  JAX's platform guard, re-exec and XLA
compile cache are TPU plumbing with no counterpart here.

Tenancy: each run executes under the job's tenant's ResourceGovernor
(tenants.json budgets).  A budget breach raises the engine's typed
ResourceExhausted INSIDE the job — the daemon writes that job an rc-75
verdict and keeps serving; sibling jobs and the daemon itself never see
it.  Any other per-job exception becomes an error verdict (exit_code 2)
the same way: one tenant's bad config cannot take the service down.

Liveness: the daemon appends heartbeat lines to
``service/heartbeat.jsonl`` — every few seconds when idle (size-rotated
so a serve-forever daemon stays bounded), and from a background thread
while the main thread is inside a long engine run, so the supervisor's
stall detector (``cli serve --supervised``;
resilience.supervisor.daemon_supervisor_config) kills wedged daemons,
never merely busy ones.
Queue depth, cache hit/miss, batch sizes and submit->verdict latency are
exported to ``service/metrics.prom`` for scraping.

Shutdown: SIGTERM/SIGINT finish the in-flight group, then exit 0; claims
of a killed daemon are re-queued by the next daemon's startup janitor.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import durable_io as _dio
from ..utils import clock as _clk
from ..engine.bfs import check, resolve_device
from ..interop import to_u32
from ..obs import RunContext, fleettrace
from ..obs.metrics import MetricsRegistry
from ..resilience.faults import FaultPlan, InjectedCrash, injected_skew_s
from ..resilience.heartbeat import append_jsonl, heartbeat_record
from ..resilience.integrity import EXIT_INTEGRITY, IntegrityError
from ..resilience.resources import ResourceExhausted
from .batch import Member, derive_member, explore_shared
from .kernel_cache import (
    KernelCache,
    job_cfg,
    job_invariants,
    resolve_kernel_source,
)
from .queue import JobQueue
from .scheduler import TenantPolicy, plan_groups, union_invariants
from .verdict import (
    EXIT_RESOURCE,
    error_verdict,
    verdict_from_result,
)

# Idle heartbeat/export cadence.  The supervisor's stall detector only
# needs the heartbeat file to change within --stall-timeout (default
# 120s); ticking every poll interval (0.2s) would append ~432k lines/day
# to an IDLE serve-forever daemon for no extra liveness.
_IDLE_TICK_S = 5.0
# While a group is EXECUTING the main thread is inside the engine for
# arbitrarily long (a cold first job of a big shape is minutes of model
# build + compile), so a background thread keeps the heartbeat moving —
# otherwise --supervised would stall-kill a merely-busy daemon mid-job,
# requeue the claim, and kill the identical cold re-run forever.
_BUSY_HEARTBEAT_S = 5.0
# Rotation bound for heartbeat.jsonl: a serve-forever daemon must not
# grow it without limit.  Shrinking is safe — the stall detector treats
# ANY size change as progress (supervisor._run_attempt).
_HEARTBEAT_MAX_BYTES = 2 << 20
_HEARTBEAT_KEEP_LINES = 500


@dataclass
class ServeConfig:
    service_dir: str
    poll_s: float = 0.2
    linger_s: float = 0.05  # second claim sweep so a burst coalesces
    max_jobs: Optional[int] = None  # exit after N verdicts (bench/tests)
    idle_exit_s: Optional[float] = None  # exit after this long idle
    min_bucket: int = 256
    chunk_size: int = 32768
    visited_backend: str = "device"
    # where the jobs run: None is the card, which must be there; "cpu"
    # runs the plain versions of the kernels (cli serve --cpu)
    device: Optional[str] = None
    cache_entries: int = 32
    batching: bool = True
    # group-width cap (scheduler.plan_groups max_group=): a sweep can
    # legitimately queue hundreds of same-shape jobs in one drain, and
    # the batch runner holds the whole envelope exploration in RAM —
    # cap how many coalesce per engine run.  None/0 = unlimited (the
    # historical behavior); KSPEC_MAX_GROUP is the env twin.
    max_group: Optional[int] = None
    # fleet identity (service/fleet.py): instance i writes its OWN
    # heartbeat/metrics files (heartbeat-<i>.jsonl) so the fleet
    # supervisor can watch each daemon separately, answers to the
    # drain marker service/drain/<i>, and is the target of
    # crash@daemon<i>/stall@daemon<i> faults.  None (a solo `cli
    # serve`) keeps the historical shared paths.  KSPEC_DAEMON_INSTANCE
    # is the env twin the fleet launcher sets.
    instance: Optional[int] = None
    # persistent state-space cache (service/state_cache.py): repeat
    # checks of an unchanged config become chain-verified cache hits,
    # config-delta checks seed from the cached boundary.  Trust-but-
    # verify: any artifact problem degrades to a cold run with a
    # cache-fallback event — it can never produce a wrong verdict.
    state_cache: bool = True
    # cache federation: the cache root defaults to
    # <svc>/state-cache, but pointing N hosts' daemons at ONE shared
    # directory (--state-cache-dir / $KSPEC_STATE_CACHE_DIR) gives them a
    # federated namespace — entries are content-addressed and re-proven
    # on every read, so host B serves host A's publishes chain-verified
    # with no coordination beyond the filesystem
    state_cache_dir: Optional[str] = None


class Daemon:
    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        # before anything touches the queue: without the card (and no
        # device="cpu") the daemon must not claim a job it cannot run
        self.device = resolve_device(cfg.device)
        # daemon-level fault plan (crash@daemon<i>:N / stall@daemon<i> /
        # flip@cache:N / enospc@cache:N): parsed once from the daemon's
        # OWN environment — per-job --fault plans ride the job governor
        # and never reach these hooks; a plan naming a site the port does
        # not wire is refused, as check() refuses one
        self.fault = FaultPlan.from_env()
        unwired = self.fault.unwired()
        if unwired:
            raise ValueError(
                f"fault plan {self.fault.spec!r}: site(s) {', '.join(unwired)} are not "
                "wired in the port's serving daemon"
            )
        self.queue = JobQueue(cfg.service_dir)
        self.policy = TenantPolicy(self.queue.tenants_path)
        self.cache = KernelCache(max_entries=cfg.cache_entries)
        os.makedirs(self.queue.service_dir, exist_ok=True)
        # fleet identity: instance i gets its own heartbeat/metrics files
        # (the fleet supervisor watches per-daemon liveness), a drain
        # marker path, and the daemon-scoped fault sites armed
        if cfg.instance is None and os.environ.get("KSPEC_DAEMON_INSTANCE"):
            cfg.instance = int(os.environ["KSPEC_DAEMON_INSTANCE"])
        self.instance = cfg.instance
        sfx = "" if self.instance is None else f"-{self.instance}"
        self.heartbeat_path = os.path.join(
            self.queue.service_dir, f"heartbeat{sfx}.jsonl"
        )
        self.metrics_suffix = sfx
        self.events_path = os.path.join(
            self.queue.service_dir, "events.jsonl"
        )
        self.drain_marker = (
            None
            if self.instance is None
            else os.path.join(
                self.queue.service_dir, "drain", str(self.instance)
            )
        )
        self.fault.set_instance(self.instance if self.instance is not None
                                else 0)
        # host identity (service/router.py): each host of a routed fleet
        # exports KSPEC_HOST_INSTANCE=<i> to its daemons, arming the
        # host-scoped chaos faults (kill@host<i> / partition@host<i> /
        # skew@host<i>) for exactly that host's processes
        if os.environ.get("KSPEC_HOST_INSTANCE"):
            try:
                self.fault.set_host(int(os.environ["KSPEC_HOST_INSTANCE"]))
            except ValueError:
                pass
        self.state_cache = None
        if cfg.state_cache:
            from .state_cache import StateSpaceCache

            self.state_cache = StateSpaceCache(
                cfg.state_cache_dir
                or os.environ.get("KSPEC_STATE_CACHE_DIR")
                or os.path.join(self.queue.dir, "state-cache"),
                fault_plan=self.fault,
                event=self._event,
            )
        # partition@host<i> window state: while _partition_left > 0 the
        # next jobs' cache lookups degrade to typed cold runs and their
        # publishes are deferred here, re-published when the window
        # closes (the heal) — the shared namespace was LOST, not the
        # daemon, so the work it completed meanwhile still federates
        self._partition_left = 0
        self._partition_ids: set = set()
        self._partition_deferred: list = []
        self._seeds: dict = {}  # job_id -> engine seed dict (cache delta)
        self._trace_buf: list = []  # solo runs' trace store (publication)
        self._janitor_last = 0.0
        # metrics identity: the run_id distinguishes daemon instances and
        # the const labels carry instance + host, so N fleet daemons'
        # scraped series (one metric namespace) never collide
        labels = {}
        if self.instance is not None:
            labels["instance"] = str(self.instance)
        if os.environ.get("KSPEC_HOST_INSTANCE"):
            labels["host"] = os.environ["KSPEC_HOST_INSTANCE"]
        self.metrics = MetricsRegistry(
            run_id="service" + self.metrics_suffix, const_labels=labels
        )
        self.jobs_done = 0
        self.groups_run = 0
        self._stop = False
        self._last_work = _clk.monotonic()
        self._last_tick = 0.0
        # busy-heartbeat plumbing: the job ids of the group the main
        # thread is currently executing (None = idle), and the event that
        # shuts the heartbeat thread down with the daemon
        self._busy_jobs: Optional[list] = None
        # every claim of the current drain sweep that has not finished
        # yet: lease renewal must cover claims QUEUED BEHIND the active
        # group too (a sweep of several cold groups runs for many
        # minutes, and a sibling janitor must not read the later groups'
        # original-claim-time leases as expired and steal live work)
        self._sweep_jobs: list = []
        self._hb_stop = threading.Event()
        # both the main thread (_tick) and the busy-heartbeat thread write
        # heartbeat.jsonl and may rotate it; unserialized, two rotations
        # would interleave writes to the same .tmp and drop appends that
        # land between a rotation's read and its publish
        self._hb_lock = threading.Lock()

    # --- lifecycle --------------------------------------------------------
    def request_stop(self, *_a) -> None:
        self._stop = True

    def serve(self) -> int:
        """Run until stop/idle-exit/max-jobs; returns a process exit code."""
        old_term = signal.signal(signal.SIGTERM, self.request_stop)
        old_int = signal.signal(signal.SIGINT, self.request_stop)
        orphans = self.queue.requeue_orphans()
        self._event("daemon-start", pid=os.getpid(), requeued=len(orphans))
        print(
            f"[serve] daemon up: dir={self.queue.dir} pid={os.getpid()}"
            + (f" (requeued {len(orphans)} orphaned claims)" if orphans
               else ""),
            file=sys.stderr,
        )
        hb_thread = threading.Thread(
            target=self._busy_heartbeat_loop, daemon=True
        )
        hb_thread.start()
        try:
            while not self._stop:
                if self._drain_requested():
                    # graceful drain (fleet scale-down): every claimed
                    # job of the previous sweep is finished — take no new
                    # work, exit 0; the fleet reaps the slot
                    self._event("daemon-drain-exit", jobs=self.jobs_done)
                    break
                self._periodic_janitor()
                n = self.drain_once()
                self._tick(worked=bool(n))
                if n:
                    self._last_work = _clk.monotonic()
                else:
                    if self.cfg.idle_exit_s is not None and (
                        _clk.monotonic() - self._last_work
                        > self.cfg.idle_exit_s
                    ):
                        self._event("daemon-idle-exit")
                        break
                    _clk.sleep(self.cfg.poll_s)
                if (
                    self.cfg.max_jobs is not None
                    and self.jobs_done >= self.cfg.max_jobs
                ):
                    self._event("daemon-max-jobs", jobs=self.jobs_done)
                    break
        finally:
            self._hb_stop.set()
            hb_thread.join(timeout=2.0)
            self._event("daemon-stop", jobs=self.jobs_done)
            self._export_metrics(jsonl=True)
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)
        return 0

    # --- one queue sweep --------------------------------------------------
    def drain_once(self) -> int:
        """Claim everything pending (plus one linger sweep), run it
        grouped.  Returns the number of verdicts written."""
        claimed = self.queue.claim_pending()
        if claimed and self.cfg.linger_s:
            _clk.sleep(self.cfg.linger_s)  # let an in-flight burst land
            claimed += self.queue.claim_pending()
        # stall@daemon<i> wedges HERE — after the claim sweep, before any
        # lease renewal starts — so the injected failure is exactly the
        # one the fleet exists to survive: a wedged daemon sitting on
        # freshly leased claims (never returns when armed)
        self._maybe_wedge()
        if not claimed:
            return 0
        jobs = []
        done = 0  # verdicts written this sweep — short-circuits and parse
        # failures count too, or a stream of bad specs reads as "idle" to
        # the idle-exit timer while the daemon is actively publishing
        for spec in claimed:
            prior = self.queue.result(spec["job_id"])
            if prior is not None:
                # requeued orphan that already published its verdict:
                # retire the claim, never re-run (at-most-once
                # visibility).  Routed through _finish_job so the
                # published verdict counts toward --max-jobs, the
                # jobs_done gauge and kspec_svc_jobs_total like any
                # other — a controlled drain (serve --max-jobs N) must
                # terminate on it, not serve forever past it
                try:
                    self._finish_job(spec, prior)
                    done += 1
                except Exception:  # noqa: BLE001 — verdict already durable
                    pass
                continue
            try:
                cfg = job_cfg(spec)
                emitted = resolve_kernel_source(
                    spec.get("kernel_source", "auto"), spec["module"]
                )
                if self._consult_state_cache(spec, cfg, emitted):
                    done += 1  # chain-verified cache hit: verdict
                    continue  # published, nothing to run
                jobs.append((spec, cfg, emitted))
            except Exception as e:  # noqa: BLE001 — tenant input
                done += self._fail_jobs([spec], f"cannot parse job cfg: {e}")
        max_group = self.cfg.max_group
        if max_group is None and os.environ.get("KSPEC_MAX_GROUP"):
            try:
                max_group = int(os.environ["KSPEC_MAX_GROUP"])
            except ValueError:
                max_group = None
        t_plan = fleettrace.now()
        groups = (
            plan_groups(jobs, max_group=max_group)
            if self.cfg.batching
            else [[j] for j in jobs]
        )
        for group in groups:
            for spec, _c, _e in group:
                fleettrace.emit_span(
                    self.queue.dir, spec.get("trace"), "sched-group",
                    t_plan, fleettrace.now(), job_id=spec["job_id"],
                    group_size=len(group),
                    leader=group[0][0]["job_id"],
                    instance=self.instance,
                )
        self._sweep_jobs = [
            spec["job_id"] for group in groups for spec, _c, _e in group
        ]
        try:
            for group in groups:
                try:
                    done += self._run_group(group)
                finally:
                    # every exit path — normal, error-verdict returns, or
                    # an unexpected escape — must close the busy-heartbeat
                    # window
                    self._busy_jobs = None
                if self._stop:
                    break
        finally:
            self._sweep_jobs = []
        return done

    # --- group execution --------------------------------------------------
    def _run_group(self, group: list) -> int:
        specs = [spec for spec, _c, _e in group]
        leader_spec, leader_cfg, emitted = group[0]
        tenant = leader_spec.get("tenant", "default")
        # crash@daemon<i>:N (resilience.faults): the injected daemon
        # death fires BEFORE any verdict work for the Nth job, so the
        # group's claims stay leased and a sibling's janitor requeues
        # them — the exactly-once-visible-verdict drill for the fleet.
        # InjectedCrash is deliberately NOT caught by any handler below:
        # the process must die like the real crash it rehearses.  The
        # fired-marker makes the drill once-per-service-dir, so the
        # fleet's restarted daemon converges instead of crash-looping.
        if self._daemon_fault_armed("crash"):
            try:
                self.fault.daemon_crash(
                    self.jobs_done + 1, self.jobs_done + len(group)
                )
            except InjectedCrash:
                self._mark_daemon_fault("crash")
                raise
        # kill@host<i>:N, the whole-host-death drill (service/router.py):
        # crash@daemon's firing point and exactly-once story, scoped by
        # KSPEC_HOST_INSTANCE so one composed plan targets one host of a
        # routed fleet.  The router sees the host's heartbeats go stale
        # and re-routes its pending jobs; the leased claims come back
        # through the takeover protocol.
        if self._daemon_fault_armed("kill"):
            try:
                self.fault.host_kill(
                    self.jobs_done + 1, self.jobs_done + len(group)
                )
            except InjectedCrash:
                self._mark_daemon_fault("kill")
                raise
        # the busy-heartbeat window opens BEFORE the model-cache lookup:
        # a cold miss runs build_model + prepare, and without
        # a moving heartbeat --supervised would stall-kill the daemon
        # mid-build, requeue the claim, and kill the identical re-build
        # forever (drain_once clears this on every exit path)
        self._busy_jobs = [s["job_id"] for s in specs]
        # EVERY singleton group takes the real solo engine path — first-
        # violation early exit, streamed levels (no collect_levels RAM),
        # full check_deadlock semantics — still warm through the kernel
        # cache; only groups of >= 2 pay the shared-exploration envelope.
        # (solo_only additionally keeps deadlock/fault jobs out of groups
        # at planning time — the post-hoc derivation cannot replay them.)
        # This also makes --no-batching exactly what its help says: every
        # group is a singleton, so every job runs real solo semantics.
        solo = len(group) == 1
        t0 = time.perf_counter()
        try:
            invs = (
                job_invariants(leader_spec["module"], leader_cfg)
                if solo else union_invariants(group)
            )
            members = [
                Member(
                    spec["job_id"],
                    job_invariants(spec["module"], cfg),
                    max_depth=spec.get("max_depth"),
                    max_states=spec.get("max_states"),
                )
                for spec, cfg, _e in group
            ]
            entry = self.cache.get(
                leader_spec["module"], leader_cfg, emitted, invs
            )
        except Exception as e:  # noqa: BLE001 — bad module/constants
            return self._fail_jobs(specs, f"cannot build model: {e}")
        self._cache_metrics(entry)
        fault = leader_spec.get("fault")
        leader_ctx = None
        try:
            # durable=False: a service run dir is pure observability — the
            # queue's verdict file is the job's durable record, and the
            # manifest fsyncs were the warm path's latency floor (~5/job)
            leader_ctx = RunContext(
                self.queue.run_dir(leader_spec["job_id"]), durable=False
            )
            leader_ctx.record_config(
                module=leader_spec["module"],
                engine="service",
                service={
                    "job_id": leader_spec["job_id"],
                    "tenant": tenant,
                    "group_size": len(group),
                    "group_jobs": [s["job_id"] for s in specs],
                    "cache_hit": entry["hit"],
                    **(
                        {"takeover": leader_spec["takeovers"][-1]}
                        if leader_spec.get("takeovers")
                        else {}
                    ),
                    **(
                        {"state_cache_seed": True}
                        if leader_spec.get("_state_cache_seed")
                        else {}
                    ),
                },
            )
            # a tenant-budgeted governor replaces the engine's env-derived
            # one wholesale, so the job's fault plan must ride in it —
            # otherwise governor-level faults (stall@level) silently no-op
            # for every budgeted tenant while working for unbudgeted ones
            governor = self.policy.governor(
                tenant,
                watch_dirs=[leader_ctx.dir],
                fault_plan=FaultPlan(fault) if fault else None,
            )
        except Exception as e:  # noqa: BLE001 — a malformed fault plan /
            # unwritable run dir is THAT job's problem, not the daemon's:
            # crashing here would strand the group in claimed/ and hot-loop
            # the janitor-requeue -> identical-crash cycle
            if leader_ctx is not None:
                self._close_run(leader_ctx, "error", str(e))
            return self._fail_jobs(specs, f"cannot start job: {e}")
        old_fault = os.environ.get("KSPEC_FAULT")
        if fault:
            os.environ["KSPEC_FAULT"] = fault
        seed = None
        seed_depth = None
        try:
            if solo:
                shared = None
                seed = self._seeds.pop(leader_spec["job_id"], None)

                def _run_solo(seed_arg):
                    # publication needs the per-level packed rows: alias
                    # the engine's trace store (zero extra memory) on
                    # COLD cacheable runs; seeded runs force
                    # store_trace off, so they neither collect nor
                    # publish (the JAX package's docs/service.md, State-space cache)
                    collect = (
                        self._trace_buf
                        if seed_arg is None
                        and self.state_cache is not None
                        and not fault
                        else None
                    )
                    return check(
                        entry["model"],
                        max_depth=leader_spec.get("max_depth"),
                        max_states=leader_spec.get("max_states"),
                        store_trace=True,
                        min_bucket=self.cfg.min_bucket,
                        check_deadlock=leader_cfg.check_deadlock,
                        chunk_size=self.cfg.chunk_size,
                        visited_backend=self.cfg.visited_backend,
                        prepared=entry["prepared"],
                        run=leader_ctx,
                        governor=governor,
                        visited_capacity_exact=(
                            entry["prepared"].capacity_hint
                        ),
                        seed=seed_arg,
                        collect_trace=collect,
                        device=self.device,
                    )

                try:
                    solo_res = _run_solo(seed)
                    seed_depth = seed["depth"] if seed else None
                except InjectedCrash:
                    raise  # the process is expected to die
                except Exception as e:  # noqa: BLE001 — trust-but-verify:
                    # a seeded run that fails for ANY reason degrades to
                    # the cold run it replaced (typed cache-fallback);
                    # only an unseeded failure is the job's real error
                    if seed is None:
                        raise
                    self._event(
                        "cache-fallback",
                        reason=f"seed-error: {str(e)[:200]}",
                        jobs=[leader_spec["job_id"]],
                    )
                    self.metrics.inc("kspec_svc_state_cache_fallbacks_total")
                    seed = None
                    solo_res = _run_solo(None)
                entry["prepared"].note_result(solo_res)
            else:
                shared = explore_shared(
                    entry["model"],
                    members,
                    prepared=entry["prepared"],
                    min_bucket=self.cfg.min_bucket,
                    chunk_size=self.cfg.chunk_size,
                    visited_backend=self.cfg.visited_backend,
                    run=leader_ctx,
                    governor=governor,
                    device=self.device,
                )
        except ResourceExhausted as e:
            # the engine's typed path already stamped the manifest
            # 'resource-exhausted' and closed its observer; the deactivate
            # here is a no-op belt for partial paths
            self._close_run(leader_ctx, None)
            self._event(
                "job-resource-exhausted", tenant=tenant, reason=e.reason,
                jobs=[s["job_id"] for s in specs],
            )
            n = 0
            for spec in specs:
                try:
                    self._finish_job(
                        spec,
                        self._stamp(
                            spec,
                            error_verdict(
                                f"RESOURCE_EXHAUSTED[{e.reason}]: "
                                f"{e.detail}",
                                run_id=leader_ctx.run_id,
                                exit_code=EXIT_RESOURCE,
                            ),
                            status="resource-exhausted",
                        ),
                    )
                    n += 1
                except Exception:  # noqa: BLE001 — a second ENOSPC must
                    pass  # not crash the daemon; the claim stays for the
                    # next janitor
            return n
        except IntegrityError as e:
            # typed like the resource path: the engine stamped the run
            # manifest 'integrity-violation' and closed its observer;
            # each member job gets an rc-76 verdict and the daemon (and
            # its sibling jobs) keeps serving — one tenant's corrupted
            # run never takes the service down
            self._close_run(leader_ctx, None)
            self._event(
                "job-integrity-violation", tenant=tenant, site=e.site,
                jobs=[s["job_id"] for s in specs],
            )
            n = 0
            for spec in specs:
                try:
                    self._finish_job(
                        spec,
                        self._stamp(
                            spec,
                            error_verdict(
                                f"INTEGRITY_VIOLATION[{e.site}]: "
                                f"{e.detail}",
                                run_id=leader_ctx.run_id,
                                exit_code=EXIT_INTEGRITY,
                            ),
                            status="integrity-violation",
                        ),
                    )
                    n += 1
                except Exception:  # noqa: BLE001 — same belt as rc-75
                    pass
            return n
        except Exception as e:  # noqa: BLE001 — keep the daemon alive
            # the engine does NOT close its observer on a generic raise:
            # stamp + release here or every such failure leaks a tracer fd
            self._close_run(leader_ctx, "error", str(e))
            self._event(
                "job-error", tenant=tenant, error=str(e)[:300],
                jobs=[s["job_id"] for s in specs],
            )
            return self._fail_jobs(specs, f"engine failure: {e}")
        finally:
            if fault:
                if old_fault is None:
                    os.environ.pop("KSPEC_FAULT", None)
                else:
                    os.environ["KSPEC_FAULT"] = old_fault
        n = self._publish_group(
            group, members, specs, leader_spec, leader_ctx,
            solo, solo_res if solo else None, shared, t0,
            seed_depth=seed_depth, cache_entry=entry,
        )
        if solo and self.state_cache is not None and not fault:
            # completed solo run: publish it as a state-space-cache entry
            # (files-first + atomic entry promote; every failure is a
            # cache-fallback event, never a job failure).  Cold runs
            # publish the full seedable artifact from their trace rows;
            # seeded runs publish a verdict-only entry (their trace
            # store has no below-seed levels), which still turns the
            # NEXT repeat check into an O(verify) hit
            # the trace store's rows (on the card) come to the host as the
            # packed uint32 rows the artifact holds
            rows = (
                [to_u32(t[0]) for t in self._trace_buf]
                if seed is None and solo_res.violation is None
                else None
            )
            self._trace_buf = []
            self._publish_state_cache(
                leader_spec, leader_cfg, emitted, entry, solo_res,
                level_rows=rows,
            )
        # the JAX package re-compiles here the steps that a run growing
        # the visited set evicted; the port compiles none, and rewarm()
        # returns 0 (engine/bfs.py::PreparedKernels.rewarm)
        try:
            warmed = entry["prepared"].rewarm()
            if warmed:
                self.metrics.inc("kspec_svc_rewarmed_steps_total", warmed)
        except Exception as e:  # noqa: BLE001 — purely an optimization
            self._event("rewarm-error", error=str(e)[:300])
        return n

    def _publish_group(self, group, members, specs, leader_spec,
                       leader_ctx, solo, solo_res, shared, t0,
                       seed_depth=None, cache_entry=None) -> int:
        """Derive + publish every member's verdict.  Runs with
        ``_busy_jobs`` still set (cleared by drain_once): derive_member
        runs per-(invariant, level) predicate passes and walks traces on
        the host, which on a big shape can outlast
        ``--supervised``'s stall timeout — ending the busy-heartbeat
        window at the engine's return would let the supervisor stall-kill
        a merely-busy daemon mid-derive and requeue the group into an
        identical kill loop."""
        wall_s = time.perf_counter() - t0
        self.groups_run += 1
        self.metrics.inc("kspec_svc_groups_total")
        if len(group) > 1:
            self.metrics.inc("kspec_svc_batched_jobs_total", len(group))
        # fleet-trace run window + stage histograms: the wall window is
        # reconstructed backward from the run's end so the span's clock
        # and the engine's perf_counter duration agree
        t_run_end = fleettrace.now()
        cache_hit = bool(cache_entry.get("hit")) if cache_entry else None
        compile_ms = (
            0.0 if cache_entry is None or cache_hit
            else round(float(cache_entry.get("build_s") or 0.0) * 1e3, 1)
        )
        if compile_ms:
            self.metrics.observe("kspec_svc_stage_compile_ms", compile_ms)
        self.metrics.observe(
            "kspec_svc_stage_explore_ms",
            max(0.0, wall_s * 1e3 - compile_ms),
        )
        for (spec, mcfg, memitted), member in zip(group, members):
            # per-member guard: a derivation/publication failure (a
            # predicate erroring on a decoded state, an OSError on a
            # member run dir) must cost THAT member an error verdict, not
            # crash the daemon with the whole group stuck in claimed/ —
            # the janitor would requeue it into an identical re-crash
            try:
                res = solo_res if solo else derive_member(shared, member)
                rec = self._stamp(
                    spec,
                    verdict_from_result(res, run_id=leader_ctx.run_id),
                    status="violation" if res.violation else "complete",
                    wall_s=wall_s,
                )
                if seed_depth is not None:
                    # config-delta run: the frontier was seeded from the
                    # cached boundary instead of Init (state_cache)
                    rec["cache"] = {
                        "state_cache": "seed",
                        "from_depth": int(seed_depth),
                    }
                if len(group) > 1:
                    rec["batch"] = {
                        "group_size": len(group),
                        "leader_run_id": leader_ctx.run_id,
                    }
                if spec is leader_spec:
                    # the engine's RunObserver already finished the
                    # manifest with the SHARED result; overwrite the
                    # summary with the member's own derived verdict +
                    # service metadata
                    leader_ctx.finish(rec["status"], **_summary(rec))
                else:
                    ctx = RunContext(
                        self.queue.run_dir(spec["job_id"]), durable=False
                    )
                    ctx.record_config(
                        module=spec["module"],
                        engine="service",
                        service={
                            "job_id": spec["job_id"],
                            "tenant": spec.get("tenant", "default"),
                            "group_size": len(group),
                            "leader_run_id": leader_ctx.run_id,
                            "cache_hit": True,  # rode the leader's kernels
                        },
                    )
                    rec["run_id"] = ctx.run_id
                    ctx.finish(rec["status"], **_summary(rec))
                self._finish_job(spec, rec)
                fleettrace.emit_span(
                    self.queue.dir, spec.get("trace"), "svc-run",
                    t_run_end - wall_s, t_run_end,
                    job_id=spec["job_id"],
                    run_id=rec.get("run_id") or leader_ctx.run_id,
                    group_size=len(group), solo=bool(solo),
                    cache_hit=cache_hit, compile_ms=compile_ms,
                    verdict=rec["status"], seed_depth=seed_depth,
                    instance=self.instance,
                )
                if not solo and self.state_cache is not None:
                    # batched members publish VERDICT-ONLY entries (their
                    # per-level rows live only in the shared record, so
                    # there is no seedable artifact) — a repeat sweep of
                    # the same lattice then O(verify)-hits every member
                    # instead of re-running the whole group.  Publication
                    # failure is a typed cache-fallback, never the job's.
                    self._publish_state_cache(
                        spec, mcfg, memitted,
                        {"model": shared.model}, res,
                        level_rows=None,
                    )
            except Exception as e:  # noqa: BLE001 — keep the daemon alive
                self._event(
                    "job-error", tenant=spec.get("tenant", "default"),
                    error=str(e)[:300], jobs=[spec["job_id"]],
                )
                try:
                    self._fail_job(spec, f"verdict derivation failed: {e}")
                except Exception:  # noqa: BLE001 — even the error verdict
                    # failed (service dir unwritable): leave the job
                    # claimed for the next daemon's janitor
                    pass
        return len(specs)

    # --- state-space cache (service/state_cache.py) -----------------------
    def _consult_state_cache(self, spec: dict, cfg, emitted: bool) -> bool:
        """Repeat-check short circuit: True when a chain-verified cache
        hit published this job's verdict (nothing to run).  A config-
        delta hit registers an engine seed for the solo path and returns
        False (the job still runs, just not from Init).  Every cache
        problem is a typed cache-fallback (inside lookup) + False."""
        if self.state_cache is None or spec.get("fault"):
            return False
        t_lk = fleettrace.now()

        def _trace_lookup(outcome: str, **attrs) -> None:
            # verify stage = the chain-verify/lookup window of the shared
            # state cache, whatever the outcome
            t1 = fleettrace.now()
            self.metrics.observe(
                "kspec_svc_stage_verify_ms", max(0.0, (t1 - t_lk) * 1e3)
            )
            fleettrace.emit_span(
                self.queue.dir, spec.get("trace"), "cache-lookup",
                t_lk, t1, job_id=spec["job_id"], outcome=outcome,
                instance=self.instance, **attrs,
            )

        if self._partition_check(spec):
            # partition@host<i>: the shared cache namespace is GONE for
            # this window — degrade to a local-cold run with the typed
            # fallback every other cache problem gets; the publish side
            # defers and re-publishes on heal
            self._event(
                "cache-fallback", reason="partition",
                jobs=[spec["job_id"]],
            )
            self.metrics.inc("kspec_svc_state_cache_fallbacks_total")
            _trace_lookup("fallback", reason="partition")
            return False
        from .state_cache import CacheHit, CacheSeed, key_for_job
        from .verdict import VERDICT_SCHEMA

        try:
            key = key_for_job(
                spec, cfg, emitted,
                job_invariants(spec["module"], cfg),
            )
            found = self.state_cache.lookup(key)
        except Exception as e:  # noqa: BLE001 — the cache may never fail
            # a job: an unexpected lookup error is just a cold run
            self._event(
                "cache-fallback", reason=f"lookup-error: {str(e)[:200]}",
                jobs=[spec["job_id"]],
            )
            self.metrics.inc("kspec_svc_state_cache_fallbacks_total")
            _trace_lookup("fallback", reason="lookup-error")
            return False
        if isinstance(found, CacheHit):
            rec = dict(found.verdict)
            rec["schema"] = VERDICT_SCHEMA
            rec.setdefault("run_id", None)
            rec = self._stamp(
                spec, rec,
                status="violation" if rec.get("violation") else "complete",
            )
            rec["cache"] = {
                "state_cache": "hit",
                "reason": found.reason,
                "published_unix": found.entry.get("created_unix"),
            }
            self._finish_job(spec, rec)
            self.metrics.inc("kspec_svc_state_cache_hits_total")
            _trace_lookup("hit", reason=found.reason)
            return True
        if isinstance(found, CacheSeed):
            self._seeds[spec["job_id"]] = found.seed
            # seeded jobs must run REAL solo semantics (the engine seed
            # plugs into check(), not the batched runner)
            spec["_state_cache_seed"] = True
            self.metrics.inc("kspec_svc_state_cache_seeds_total")
            _trace_lookup("seed", from_depth=int(found.from_depth))
            return False
        self.metrics.inc("kspec_svc_state_cache_misses_total")
        _trace_lookup("miss")
        return False

    def _partition_check(self, spec: dict) -> bool:
        """True while this job's cache consultation falls inside an
        injected partition window (partition@host<i>[:N], armed lazily
        on the first consultation after the fault matches; durable
        fired-marker, so a restarted daemon converges).  The window
        counts PUBLISHING jobs: each one registers here, defers its
        publish, and the last one's deferral triggers the heal."""
        if self._partition_left == 0 and self._daemon_fault_armed(
            "partition"
        ):
            n = self.fault.host_partition()
            if n:
                self._mark_daemon_fault("partition")
                self._partition_left = n
                self._event("cache-partition-injected", jobs_degraded=n)
        if self._partition_left <= 0:
            return False
        self._partition_ids.add(spec["job_id"])
        return True

    def _heal_partition(self) -> None:
        """The partition window closed: the shared namespace is back, so
        everything completed meanwhile re-publishes — the federation
        sees the host's partitioned work as if it had never dropped off."""
        deferred, self._partition_deferred = self._partition_deferred, []
        for args in deferred:
            self._publish_state_cache(*args)
        self._event("cache-partition-heal", republished=len(deferred))

    def _publish_state_cache(self, spec, cfg, emitted, entry, res,
                             level_rows=None) -> None:
        from .state_cache import key_for_job

        jid = spec.get("job_id")
        if jid in self._partition_ids:
            # mid-partition: the namespace is unreachable — defer, and
            # re-publish when the window closes (never publish into a
            # namespace the fault says we cannot see)
            self._partition_ids.discard(jid)
            self._partition_deferred.append(
                (spec, cfg, emitted, entry, res, level_rows)
            )
            self._partition_left = max(0, self._partition_left - 1)
            self._event(
                "cache-publish-deferred", reason="partition", jobs=[jid],
            )
            if self._partition_left == 0:
                self._heal_partition()
            return
        t_pub = fleettrace.now()
        published = False
        try:
            key = key_for_job(
                spec, cfg, emitted, job_invariants(spec["module"], cfg)
            )
            rows = level_rows
            if rows is not None:
                # an exhausted run's trace store carries one trailing
                # EMPTY level (the final zero-new iteration) beyond the
                # levels list — trim it; any other length mismatch
                # (violation early-exit) means no artifact
                rows = list(rows)
                while len(rows) > len(res.levels) and not len(rows[-1]):
                    rows.pop()
                if len(rows) != len(res.levels):
                    rows = None
            if self.state_cache.publish(
                key,
                verdict_from_result(res),
                exact64=bool(entry["model"].spec.exact64),
                lanes=int(entry["model"].spec.num_lanes),
                level_rows=rows,
                diameter=res.diameter,
            ):
                self.metrics.inc("kspec_svc_state_cache_publish_total")
                published = True
        except Exception as e:  # noqa: BLE001 — publication is an
            # optimization: its failure must never fail the job
            self._event(
                "cache-fallback", reason=f"publish-error: {str(e)[:200]}",
            )
            self.metrics.inc("kspec_svc_state_cache_fallbacks_total")
        fleettrace.emit_span(
            self.queue.dir, spec.get("trace"), "cache-publish",
            t_pub, fleettrace.now(), job_id=jid,
            published=published, verdict_only=level_rows is None,
            instance=self.instance,
        )

    # --- helpers ----------------------------------------------------------
    def _stamp(self, spec: dict, rec: dict, status: str,
               wall_s: Optional[float] = None) -> dict:
        now = _clk.now()
        rec["job_id"] = spec["job_id"]
        rec["tenant"] = spec.get("tenant", "default")
        rec["status"] = status
        if spec.get("takeovers"):
            # the job reached this daemon via a janitor takeover from a
            # dead/wedged claimer: attribute it in the verdict (and `cli
            # report` renders it from the run manifest's service block)
            last = dict(spec["takeovers"][-1])
            last["count"] = len(spec["takeovers"])
            rec["takeover"] = last
        sub = spec.get("submitted_unix")
        claim = spec.get("claimed_unix")
        rec["timing"] = {
            "submitted_unix": sub,
            "claimed_unix": claim,
            "done_unix": round(now, 3),
            "wait_s": round(claim - sub, 3) if sub and claim else None,
            "wall_s": round(wall_s, 3) if wall_s is not None else None,
            "latency_s": round(now - sub, 3) if sub else None,
        }
        if rec["timing"]["latency_s"] is not None:
            self.metrics.observe(
                "kspec_svc_latency_ms", rec["timing"]["latency_s"] * 1e3
            )
        if rec["timing"]["wait_s"] is not None:
            self.metrics.observe(
                "kspec_svc_stage_queue_wait_ms",
                max(0.0, rec["timing"]["wait_s"] * 1e3),
            )
        return rec

    def _finish_job(self, spec: dict, rec: dict) -> None:
        t_fin = fleettrace.now()
        self.queue.finish(spec["job_id"], rec)
        t_done = fleettrace.now()
        self.metrics.observe(
            "kspec_svc_stage_publish_ms", max(0.0, (t_done - t_fin) * 1e3)
        )
        fleettrace.emit_span(
            self.queue.dir, spec.get("trace"), "verdict-publish",
            t_fin, t_done, job_id=spec["job_id"],
            status=rec.get("status", "?"),
            cache=(rec.get("cache") or {}).get("state_cache"),
            instance=self.instance,
        )
        try:  # finished jobs leave the lease-renewal set immediately
            self._sweep_jobs.remove(spec["job_id"])
        except ValueError:
            pass
        self.jobs_done += 1
        self.metrics.inc("kspec_svc_jobs_total", status=rec.get("status", "?"))

    def _fail_job(self, spec: dict, message: str) -> None:
        self._finish_job(
            spec, self._stamp(spec, error_verdict(message), status="error")
        )

    def _fail_jobs(self, specs: list, message: str) -> int:
        """Best-effort error verdicts; returns how many were written.  A
        failure writing even the ERROR verdict (ENOSPC on the service
        dir) must not crash the daemon into the janitor-requeue crash
        loop — the job stays claimed for the next daemon's janitor."""
        n = 0
        for spec in specs:
            try:
                self._fail_job(spec, message)
                n += 1
            except Exception:  # noqa: BLE001
                pass
        return n

    @staticmethod
    def _close_run(ctx, status: Optional[str], error: Optional[str] = None):
        """Best-effort terminal cleanup for a run dir whose engine died
        outside the engine's own terminal paths (the engine finishes the
        manifest and closes the tracer fd only on clean/typed exits): a
        tenant repeatedly crashing the engine must not leak one tracer fd
        per failure (EMFILE eventually takes every tenant down), and the
        run index must not report the dir as 'running' forever under the
        daemon's live pid.  status=None skips the manifest stamp (the
        engine already wrote its own terminal status, e.g.
        'resource-exhausted')."""
        try:
            if status is not None:
                ctx.finish(status, **({"error": error[:300]} if error
                                      else {}))
        except Exception:  # noqa: BLE001
            pass
        try:
            ctx.deactivate()  # idempotent: closed fd / cleared tracer ok
        except Exception:  # noqa: BLE001
            pass

    def _cache_metrics(self, entry: dict) -> None:
        if entry["hit"]:
            self.metrics.inc("kspec_svc_cache_hits_total")
        else:
            self.metrics.inc("kspec_svc_cache_misses_total")
            self.metrics.observe(
                "kspec_svc_model_build_ms", entry["build_s"] * 1e3
            )

    def _event(self, kind: str, **fields) -> None:
        if self.instance is not None:
            fields.setdefault("instance", self.instance)
        try:
            append_jsonl(
                self.events_path,
                heartbeat_record("service", event=kind, **fields),
            )
        except OSError:
            pass  # telemetry on a full disk must never take the daemon down

    def _drain_requested(self) -> bool:
        """True once the fleet has marked this instance for graceful
        retirement (service/drain/<i>): finish what is claimed, take no
        new jobs, exit 0."""
        return self.drain_marker is not None and os.path.exists(
            self.drain_marker
        )

    def _periodic_janitor(self) -> None:
        """requeue_orphans is not only a STARTUP janitor: a live daemon
        sweeping it periodically is what lets a healthy sibling take
        over a wedged daemon's claims at lease expiry without anyone
        restarting anything (the fleet's takeover primitive).  Cadence
        tracks the lease TTL so a short-TTL test observes takeover in
        seconds while a production daemon sweeps at most every 30s."""
        import time as _t

        ttl = float(os.environ.get("KSPEC_CLAIM_LEASE_TTL", 900.0))
        interval = min(30.0, max(0.5, ttl / 3.0))
        now = _t.monotonic()
        if now - self._janitor_last < interval:
            return
        self._janitor_last = now
        try:
            moved = self.queue.requeue_orphans()
        except OSError:
            return
        if moved:
            self._event("lease-takeover", jobs=sorted(moved))
            self.metrics.inc("kspec_svc_takeovers_total", len(moved))

    def _daemon_fault_marker(self, kind: str) -> str:
        return os.path.join(
            self.queue.service_dir, "faults-fired",
            f"{kind}-daemon{self.instance if self.instance is not None else 0}",
        )

    def _daemon_fault_armed(self, kind: str) -> bool:
        """Daemon-scoped faults fire ONCE PER SERVICE DIR, not once per
        process: a restarted daemon re-reads KSPEC_FAULT, and without
        this durable fired-marker a crash@daemon<i> drill would re-kill
        every restart into a crash loop.  Same convergence rule as
        crash@level's checkpoint deferral — a supervised restart must
        converge, never re-rehearse."""
        return not os.path.exists(self._daemon_fault_marker(kind))

    def _mark_daemon_fault(self, kind: str) -> None:
        try:
            path = self._daemon_fault_marker(kind)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w"):
                pass
        except OSError:
            pass  # worst case the drill re-fires; never block the fault

    def _maybe_wedge(self) -> None:
        """stall@daemon<i> (resilience.faults): deterministically wedge
        THIS daemon after a claim sweep — claims held, leases never
        renewed again, heartbeat frozen.  The fleet supervisor's stall
        detector kills the process; a sibling's janitor takes the claims
        over at lease expiry.  The sleep loop never returns."""
        if not self._daemon_fault_armed("stall"):
            return
        if not self.fault.daemon_stalled():
            return
        self._mark_daemon_fault("stall")
        self._event("daemon-wedge-injected", pid=os.getpid())
        while True:  # pragma: no cover — killed externally
            _clk.sleep(3600.0)

    def _tick(self, worked: bool = False) -> None:
        now = _clk.monotonic()
        if not worked and now - self._last_tick < _IDLE_TICK_S:
            return
        self._last_tick = now
        pending = self.queue.pending_count()
        self.metrics.set_gauge("kspec_svc_queue_pending", pending)
        self.metrics.set_gauge(
            "kspec_svc_queue_claimed", self.queue.claimed_count()
        )
        self.metrics.set_gauge("kspec_svc_jobs_done", self.jobs_done)
        self.metrics.set_gauge(
            "kspec_svc_cache_entries", len(self.cache)
        )
        cs = self.cache.stats()
        self.metrics.set_gauge("kspec_svc_cache_hit_rate", cs["hit_rate"])
        self._heartbeat(pending=pending, cache=cs)
        # metrics.jsonl is an append-only snapshot stream: writing it on
        # every idle tick would grow without bound on a serve-forever
        # daemon, so snapshots land only when work happened (plus the
        # terminal export); metrics.prom is an atomic replace of constant
        # size and stays fresh every tick
        self._export_metrics(jsonl=worked)

    def _heartbeat(self, **fields) -> None:
        with self._hb_lock:
            try:
                append_jsonl(
                    self.heartbeat_path,
                    heartbeat_record(
                        "service-heartbeat",
                        # skew@host<i>:SECS shifts the clock this host
                        # stamps into cross-host-visible metadata — the
                        # router's freshness check reads these `unix`
                        # fields, and its KSPEC_CLOCK_SKEW allowance is
                        # what this fault rehearses (0-shift otherwise)
                        t=_clk.now() + injected_skew_s(),
                        pid=os.getpid(),
                        jobs_done=self.jobs_done,
                        **fields,
                    ),
                )
            except OSError:
                pass  # liveness writes must never take the daemon down
            self._rotate_heartbeat()

    def _rotate_heartbeat(self) -> None:
        """Bound heartbeat.jsonl: keep the newest lines once it outgrows
        the cap (atomic replace; any size CHANGE reads as liveness to the
        supervisor's stall detector, shrink included)."""
        try:
            if os.path.getsize(self.heartbeat_path) <= _HEARTBEAT_MAX_BYTES:
                return
            with open(self.heartbeat_path) as fh:
                tail = fh.readlines()[-_HEARTBEAT_KEEP_LINES:]
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as fh:
                fh.writelines(tail)
            _dio.replace(tmp, self.heartbeat_path)
        except OSError:
            pass  # rotation must never take the daemon down

    def _busy_heartbeat_loop(self) -> None:
        """Background thread: keep the heartbeat moving while the main
        thread is inside a long engine run (model build + compile can be
        minutes), so --supervised never stall-kills a busy daemon — and
        renew the claim LEASES of the in-flight group for the same
        reason: a sibling daemon sharing this queue directory must read
        a long-running job as live, not orphaned (queue.requeue_orphans)."""
        while not self._hb_stop.wait(_BUSY_HEARTBEAT_S):
            jobs = self._busy_jobs
            if jobs is not None:
                self._heartbeat(busy=True, jobs=jobs)
            # renew every unfinished claim of the sweep, not just the
            # active group: claims queued behind a minutes-long cold
            # build must stay visibly live to sibling janitors (a lease
            # recreated in the instant after finish retires it is a
            # dangling sidecar the next janitor sweeps — harmless)
            sweep = list(self._sweep_jobs)
            if sweep:
                try:
                    self.queue.renew_leases(sweep)
                except Exception:  # noqa: BLE001 — advisory metadata only
                    pass

    def _export_metrics(self, jsonl: bool = False) -> None:
        svc = self.queue.service_dir
        sfx = self.metrics_suffix  # per-instance files in a fleet: two
        # daemons must not alternate-overwrite one prom textfile
        if self.device.type == "cuda":
            # the port's own gauge (the JAX daemon has no card to report):
            # this process's peak device memory, a fleet's per-daemon figure
            import torch

            self.metrics.set_gauge("kspec_svc_device_peak_bytes",
                                   torch.cuda.max_memory_allocated(self.device))
        try:
            if jsonl:
                self.metrics.write_jsonl(
                    os.path.join(svc, f"metrics{sfx}.jsonl")
                )
            self.metrics.write_prom(os.path.join(svc, f"metrics{sfx}.prom"))
        except OSError:
            pass  # metrics export must never take the daemon down


def _summary(rec: dict) -> dict:
    """Manifest result summary from a verdict record."""
    out = {
        k: rec.get(k)
        for k in ("model", "distinct_states", "diameter", "seconds",
                  "states_per_sec", "exit_code")
    }
    if rec.get("violation"):
        out["violation"] = rec["violation"]
    if rec.get("error"):
        out["error"] = rec["error"]
    if rec.get("batch"):
        out["batch"] = rec["batch"]
    return out


def serve(cfg: ServeConfig) -> int:
    return Daemon(cfg).serve()
