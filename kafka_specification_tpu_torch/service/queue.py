"""Durable on-disk job queue: the tenants' side of checking-as-a-service.

The port's own copy of ``kafka_specification_tpu/service/queue.py``, with
its on-disk layout, so that either package's daemon drains the other's
queue.

Layout under one service directory (``--service-dir`` /
``$KSPEC_SERVICE_DIR``)::

    <svc>/
      queue/pending/<job_id>.json   submitted, waiting for the daemon
      queue/claimed/<job_id>.json   claimed by a live daemon (in flight)
      queue/done/<job_id>.json      terminal (spec retained for audit)
      queue/by-tenant/<digest>/<job_id>   empty admission-index markers
      results/<job_id>.json         the kspec-verdict/1 record
      runs/<job_id>/                per-job obs run directory
      service/                      daemon heartbeat/metrics/events/logs
      tenants.json                  per-tenant budgets (resilience.resources)

Every transition is a single atomic filesystem operation — submit is
tmp-write + ``os.rename`` into ``pending/``, claim and finish are
``os.rename`` between state directories, the verdict is tmp-write +
rename — so a crash at any instant leaves each job in exactly one state
and never publishes a torn spec or verdict.  A daemon that died mid-job
leaves its claims in ``claimed/``; the next daemon's startup janitor
(:meth:`JobQueue.requeue_orphans`) moves them back to ``pending/`` (job
execution is idempotent: nothing is committed until the verdict rename).

Claim leases: every claim is stamped with a sidecar
``claimed/<job_id>.lease`` recording the claimer's pid + per-process
token + a lease timestamp, renewed while the daemon works (the
busy-heartbeat loop calls :meth:`renew_leases` for every unfinished
claim of its drain sweep).  The janitor requeues a claim only when its lease
is ORPHANED — no lease file, the pid is gone, or the lease expired
(``lease_ttl``, default 900s, covering a wedged-but-alive daemon and
shared-filesystem queues where pid liveness can't be probed).  A live
sibling's claim is left alone, which is what lets two daemons share one
queue directory: both janitors run at startup, neither steals in-flight
work, and a genuinely dead daemon's claims still come back.

Job spec (``kspec-job/1``)::

    {"schema": "kspec-job/1", "job_id": ..., "tenant": ...,
     "module": ..., "cfg_text": "<inline TLC .cfg>", "cfg_path": ...,
     "kernel_source": "auto"|"emitted"|"hand",
     "max_depth": null|int, "max_states": null|int,
     "submitted_unix": <float>, "fault": null|"<KSPEC_FAULT plan>"}

The .cfg travels INLINE (the client reads the file at submit time): the
daemon never depends on the tenant's filesystem, and the job file is the
complete, self-contained unit of work.

Must stay torch-free: ``cli submit/status/result`` run on client boxes
that never pay the torch import (the whole point of the service).
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import random
import time
from typing import Optional

# one shared tmp-write+fsync+replace idiom (torch-free like this module);
# job/result paths are unique per writer so the fixed .tmp suffix is safe
from .. import durable_io as _dio
from ..obs import fleettrace
from ..obs.atomicio import atomic_write_json
# every timing decision routes through the injectable clock boundary
# (utils/clock.py; default = real time)
from ..utils import clock as _clk

JOB_SCHEMA = "kspec-job/1"

# --- transient-error retry (the torch-free submit side's core) ------------
#
# Service directories live on network filesystems in a fleet deployment,
# where stat/open/rename can fail TRANSIENTLY (EAGAIN under load, EIO on a
# flapping mount, ESTALE after a server-side rename).  A client that
# surfaces those as a raw traceback — or worse, masks them as a wrong
# answer ("unknown job", "no verdict") — makes every submit script flaky.
# Every client-side queue operation (submit/status/result/overview) runs
# through `retry_transient`: bounded exponential backoff on the transient
# errno classes only (ENOENT is NOT one — "file absent" is an answer, not
# a fault), then the last error propagates for the caller to render.
_TRANSIENT_ERRNOS = frozenset(
    v
    for v in (
        errno.EAGAIN,
        getattr(errno, "EWOULDBLOCK", errno.EAGAIN),
        errno.EIO,
        getattr(errno, "ESTALE", None),
        errno.EBUSY,
        errno.ENFILE,
        errno.EMFILE,
    )
    if v is not None
)

#: bounded backoff schedule: attempts x base (doubling, capped) — ~0.3s
#: worst case at the defaults, far below any submit script's own timeout
RETRY_ATTEMPTS = int(os.environ.get("KSPEC_QUEUE_RETRY_ATTEMPTS", "5"))
RETRY_BASE_S = float(os.environ.get("KSPEC_QUEUE_RETRY_BASE_S", "0.02"))
RETRY_CAP_S = 0.25

#: module-level jitter source; callers (tests) may pass their own seeded
#: ``random.Random`` for a reproducible backoff trace
_RETRY_RNG = random.Random()

#: allowance for wall-clock disagreement between hosts sharing a queue
#: directory (router vs claimer, janitor vs claimer): every freshness /
#: expiry comparison of a timestamp WRITTEN BY ANOTHER HOST widens its
#: window by this much, so a live claim from a slightly-behind clock is
#: never stolen (KSPEC_CLOCK_SKEW overrides; single-host deployments can
#: set it to 0)
DEFAULT_CLOCK_SKEW_S = 5.0


def clock_skew_s(explicit: Optional[float] = None) -> float:
    """The effective skew allowance.  ``explicit`` (a harness or an
    operator threading the value as a parameter) wins over the
    ``KSPEC_CLOCK_SKEW`` env default; both are clamped non-negative —
    a negative allowance would NARROW freshness windows and steal live
    claims."""
    if explicit is not None:
        return max(0.0, float(explicit))
    try:
        return max(
            0.0, float(os.environ.get("KSPEC_CLOCK_SKEW",
                                      DEFAULT_CLOCK_SKEW_S))
        )
    except ValueError:
        return DEFAULT_CLOCK_SKEW_S


def is_transient_oserror(e: OSError) -> bool:
    return e.errno in _TRANSIENT_ERRNOS


def retry_transient(fn, attempts: Optional[int] = None,
                    base: Optional[float] = None, rng=None):
    """Run `fn()`; on a transient OSError retry with bounded FULL-JITTER
    backoff, re-raising the final failure.  Non-transient OSErrors
    (ENOENT, EACCES, ...) propagate immediately — they are answers or
    real faults, not flakes.

    Full jitter (sleep ~ U[0, min(cap, base*2^i)]) instead of the plain
    capped exponential: when a fleet-wide ESTALE hits every client of a
    shared service directory at once, deterministic backoff re-collides
    the whole fleet on each retry; uniform jitter spreads the herd.
    `rng` (a ``random.Random``) makes the schedule reproducible in tests.
    """
    attempts = RETRY_ATTEMPTS if attempts is None else attempts
    base = RETRY_BASE_S if base is None else base
    rng = _RETRY_RNG if rng is None else rng
    for i in range(max(1, attempts)):
        try:
            return fn()
        except OSError as e:
            if not is_transient_oserror(e) or i >= attempts - 1:
                raise
            # the injected clock, not the wall (utils/clock.py)
            _clk.sleep(rng.uniform(0.0, min(RETRY_CAP_S,
                                            base * (2.0 ** i))))

PENDING = "pending"
CLAIMED = "claimed"
DONE = "done"

#: default seconds before an unrenewed claim lease counts as orphaned
#: (KSPEC_CLAIM_LEASE_TTL overrides; generous — the busy-heartbeat loop
#: renews every few seconds, so expiry means the claimer is truly gone
#: or wedged beyond its own supervisor's stall timeout)
DEFAULT_LEASE_TTL = 900.0

#: per-process claim token: pid alone cannot identify a claimer (a
#: restarted daemon can be handed its dead predecessor's recycled pid,
#: especially in small-pid-space containers) — leases carry pid+token,
#: and only a matching PAIR reads as "our own claim"
_PROC_TOKEN = os.urandom(8).hex()


def _pid_alive(pid: int) -> bool:
    """Best-effort pid liveness (same-host daemons).  Treats EPERM as
    alive (the pid exists under another uid) and any other failure as
    unknowable-alive=False."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except PermissionError:
        return True
    except OSError:
        return False


def new_job_id() -> str:
    """Sortable, collision-resistant without coordination (same recipe as
    obs run ids, distinct prefix so job and run ids never read alike)."""
    return "job-{}-{}-{}".format(
        time.strftime("%Y%m%dT%H%M%S", time.gmtime(_clk.now())),
        os.getpid(),
        os.urandom(3).hex(),
    )


class JobQueue:
    """One service directory's queue; safe for many concurrent submitters
    and one daemon (claims are renames: first mover wins, losers skip)."""

    def __init__(self, service_dir: str, create: bool = True,
                 skew_s: Optional[float] = None):
        """create=False opens read-only (``cli status``/``result``): a
        mistyped --service-dir must raise, not silently fabricate an
        empty service tree that masks the typo as 'no such job'.

        ``skew_s`` pins this queue's clock-skew allowance explicitly (a
        harness passes its own) — ``None`` keeps the ``KSPEC_CLOCK_SKEW``
        env default.  An explicit parameter instead of an env mutation:
        the env var is process-global and two concurrent harnesses would
        trample each other's save/restore."""
        self.skew_s = skew_s
        self.dir = os.path.normpath(service_dir)
        self.queue_dir = os.path.join(self.dir, "queue")
        self.results_dir = os.path.join(self.dir, "results")
        self.runs_dir = os.path.join(self.dir, "runs")
        self.service_dir = os.path.join(self.dir, "service")
        self.tenants_path = os.path.join(self.dir, "tenants.json")
        self.tenant_index_dir = os.path.join(self.queue_dir, "by-tenant")
        if create:
            for state in (PENDING, CLAIMED, DONE):
                os.makedirs(
                    os.path.join(self.queue_dir, state), exist_ok=True
                )
            os.makedirs(self.tenant_index_dir, exist_ok=True)
            os.makedirs(self.results_dir, exist_ok=True)
            os.makedirs(self.runs_dir, exist_ok=True)
            # the startup janitor: a publisher killed mid-atomic-write leaves a `.tmp` sibling
            # in a queue state dir that no except block will ever
            # collect.  These dirs are MULTI-writer (every client
            # constructs a JobQueue), so unlike the single-owner storage
            # structures the sweep is grace-aged: only tmps old enough
            # that no live writer can still be mid-promote are removed.
            for d in (
                os.path.join(self.queue_dir, PENDING),
                os.path.join(self.queue_dir, CLAIMED),
                os.path.join(self.queue_dir, DONE),
                self.results_dir,
            ):
                _dio.sweep_tmp(d, min_age_s=_dio.TMP_SWEEP_GRACE_S)
        elif not os.path.isdir(self.queue_dir):
            raise FileNotFoundError(
                f"no service directory at {self.dir!r} (queue/ missing — "
                "check --service-dir / $KSPEC_SERVICE_DIR)"
            )

    # --- paths ------------------------------------------------------------
    def _job_path(self, state: str, job_id: str) -> str:
        return os.path.join(self.queue_dir, state, f"{job_id}.json")

    def _lease_path(self, job_id: str) -> str:
        return os.path.join(self.queue_dir, CLAIMED, f"{job_id}.lease")

    def result_path(self, job_id: str) -> str:
        return os.path.join(self.results_dir, f"{job_id}.json")

    def run_dir(self, job_id: str) -> str:
        return os.path.join(self.runs_dir, job_id)

    def _skew(self, override: Optional[float] = None) -> float:
        """Effective skew allowance for this queue's freshness math: a
        per-call override wins, then the instance pin, then the env."""
        return clock_skew_s(override if override is not None
                            else self.skew_s)

    def _tenant_dir(self, tenant: str) -> str:
        """Per-tenant marker directory (admission-control index).  Keyed
        by a digest: tenant names are tenant input and must not be able
        to escape the index dir or collide with each other's paths."""
        digest = hashlib.sha1(tenant.encode("utf-8", "replace")).hexdigest()
        return os.path.join(self.tenant_index_dir, digest[:16])

    # --- client side ------------------------------------------------------
    def submit(
        self,
        cfg_text: str,
        module: str,
        tenant: str = "default",
        cfg_path: Optional[str] = None,
        kernel_source: str = "auto",
        max_depth: Optional[int] = None,
        max_states: Optional[int] = None,
        fault: Optional[str] = None,
        job_id: Optional[str] = None,
        solo: bool = False,
    ) -> dict:
        """Atomically publish one job spec into pending/; returns it.
        ``solo=True`` stamps the spec so the scheduler never coalesces
        this job into a batched group (the sweep portfolio marks
        predicted-expensive points this way — one huge member would drag
        its group's shared exploration out to ITS bounds envelope)."""
        if kernel_source not in ("auto", "emitted", "hand"):
            raise ValueError(f"bad kernel_source {kernel_source!r}")
        # the submit span's window must come from ONE clock (the trace
        # clock, which a skew fault shifts wholesale) — mixing the wall
        # anchor with a skewed close stamp would tear the root span
        # across two clock domains in a single record
        t_sub = fleettrace.now()
        spec = {
            "schema": JOB_SCHEMA,
            "job_id": job_id or new_job_id(),
            "tenant": tenant,
            "module": module,
            "cfg_text": cfg_text,
            "cfg_path": cfg_path,
            "kernel_source": kernel_source,
            "max_depth": max_depth,
            "max_states": max_states,
            "submitted_unix": round(_clk.now(), 3),
            "fault": fault,
        }
        if solo:
            # optional stamp (absent on non-solo specs): old daemons that
            # predate it just ignore the key — kspec-job/1 stays one schema
            spec["solo"] = True
        # the fleet trace context rides INSIDE the spec (same optional-key
        # contract as "solo"): it survives re-route, crash takeover, and
        # sweep batching with zero side channels, and components that
        # predate it no-op their stamp sites (obs/fleettrace.py)
        spec["trace"] = fleettrace.mint_trace(
            spec["job_id"], spec["submitted_unix"]
        )
        # marker BEFORE the spec publish: the admission index may briefly
        # overcount a submit that dies here (lazily cleaned on the next
        # count), but can never undercount a published job.  The whole
        # publish sequence rides the transient-retry router: a flapping
        # network mount costs a bounded backoff, never a failed client
        # (every step is idempotent, so a retry after a partial attempt
        # just re-does it)
        def publish():
            tdir = self._tenant_dir(tenant)
            os.makedirs(tdir, exist_ok=True)
            marker = os.path.join(tdir, spec["job_id"])
            _dio.write_text(marker, "")
            atomic_write_json(self._job_path(PENDING, spec["job_id"]), spec)

        retry_transient(publish)
        # the trace root: anchored at submitted_unix, closing when the
        # spec is durably visible in pending/
        fleettrace.emit_span(
            self.dir, spec["trace"], "job-submit",
            t_sub, fleettrace.now(),
            job_id=spec["job_id"], span_id=spec["trace"]["span_id"],
            tenant=tenant, module=module,
        )
        return spec

    def status(self, job_id: str) -> dict:
        """-> {job_id, state: pending|claimed|done|unknown, result?}.

        The verdict file is checked FIRST: a published verdict is
        terminal truth wherever the spec sits (a daemon that died between
        verdict write and claim retire leaves the job requeued in
        pending/ — status must still say done, like `cli result` does).
        Two scan passes for the rest: the daemon's claim is an os.rename
        racing these isfile probes, so a single sweep can miss a live job
        in the instant it moves pending -> claimed; a second sweep closes
        that window before reporting 'unknown'."""
        rec = self.result(job_id)
        if rec is not None:
            return {"job_id": job_id, "state": DONE, "result": rec}
        for _attempt in (0, 1):
            for state in (PENDING, CLAIMED, DONE):
                if self._isfile(self._job_path(state, job_id)):
                    out = {"job_id": job_id, "state": state}
                    if state == DONE:
                        rec = self.result(job_id)
                        if rec is not None:
                            out["result"] = rec
                    return out
            # the verdict may have landed while we scanned
            rec = self.result(job_id)
            if rec is not None:
                return {"job_id": job_id, "state": DONE, "result": rec}
        return {"job_id": job_id, "state": "unknown"}

    @staticmethod
    def _isfile(path: str) -> bool:
        """os.path.isfile with the transient-retry treatment: a flaky
        stat (EAGAIN/EIO/ESTALE on a network filesystem) must not read
        as "file absent" — that masks a live job as 'unknown' and a
        published verdict as 'no verdict'."""
        import stat as _stat

        def probe():
            try:
                st = os.stat(path)
            except FileNotFoundError:
                return False
            except NotADirectoryError:
                return False
            return _stat.S_ISREG(st.st_mode)

        try:
            return retry_transient(probe)
        except OSError:
            return False  # persistent non-transient failure: honest miss

    def result(self, job_id: str) -> Optional[dict]:
        def read():
            try:
                with open(self.result_path(job_id)) as fh:
                    return json.load(fh)
            except FileNotFoundError:
                return None  # no verdict yet — an answer, not a fault

        try:
            return retry_transient(read)
        except (OSError, ValueError):
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
        """Queue depths + recent terminal jobs (``cli status`` no-arg)."""
        counts = {
            state: len(self._list(state)) for state in (PENDING, CLAIMED, DONE)
        }
        recent = sorted(self._list(DONE))[-10:]
        return {"dir": self.dir, "counts": counts, "recent_done": recent}

    # --- daemon side ------------------------------------------------------
    def _list(self, state: str) -> list:
        try:
            names = retry_transient(
                lambda: os.listdir(os.path.join(self.queue_dir, state))
            )
            return [
                n[: -len(".json")] for n in names if n.endswith(".json")
            ]
        except OSError:
            return []

    def pending_count(self) -> int:
        return len(self._list(PENDING))

    def pending_for_tenant(self, tenant: str,
                           stop_at: Optional[int] = None) -> int:
        """Pending jobs queued by `tenant` (admission control), counted
        from the per-tenant marker index submit maintains: O(this
        tenant's markers) isfile probes, never an open/parse of every
        pending spec in the whole queue — one deep tenant must not make
        every OTHER tenant's submit pay an O(queue) scan.  Markers whose
        pending spec is gone (claimed/finished) are lazily removed;
        ``stop_at`` bounds the scan for threshold-only callers."""
        tdir = self._tenant_dir(tenant)
        try:
            markers = os.listdir(tdir)
        except OSError:
            return 0
        n = 0
        for job_id in markers:
            if os.path.isfile(self._job_path(PENDING, job_id)):
                n += 1
                if stop_at is not None and n >= stop_at:
                    return n
            else:
                try:  # claimed or finished since: retire the marker
                    _dio.unlink(os.path.join(tdir, job_id))
                except OSError:
                    pass
        return n

    def claimed_count(self) -> int:
        return len(self._list(CLAIMED))

    def claim_pending(self, limit: Optional[int] = None) -> list:
        """Move pending jobs to claimed/ (submit-order) and return their
        parsed specs.  Unparsable/torn specs are quarantined as done with
        no verdict rather than wedging the queue forever."""
        out = []
        for job_id in sorted(self._list(PENDING)):
            if limit is not None and len(out) >= limit:
                break
            src = self._job_path(PENDING, job_id)
            dst = self._job_path(CLAIMED, job_id)
            t_claim = fleettrace.now()
            try:
                _dio.rename(src, dst)
            except OSError:
                continue  # another daemon won the claim, or it vanished
            try:
                # rename PRESERVES the submit-time mtime: refresh it so
                # the janitor's leaseless-claim grace window (which keys
                # on the claim file's age) actually covers a claim of a
                # job that sat queued longer than the window.  Stamped
                # from the injected clock so a virtual-time janitor
                # compares like against like.
                t_mt = _clk.now()
                os.utime(dst, (t_mt, t_mt))
            except OSError:
                pass
            self._write_lease(job_id)
            try:
                with open(dst) as fh:
                    spec = json.load(fh)
                if spec.get("schema") != JOB_SCHEMA:
                    raise ValueError(
                        f"unsupported job schema {spec.get('schema')!r}"
                    )
                spec["claimed_unix"] = round(_clk.now(), 3)
                fleettrace.emit_span(
                    self.dir, spec.get("trace"), "queue-claim",
                    t_claim, fleettrace.now(), job_id=job_id,
                    claimer_pid=os.getpid(),
                )
                out.append(spec)
            except FileNotFoundError:
                # the claim vanished after we won the rename — a sibling
                # daemon's janitor requeued it (it cannot tell a live
                # claim from an orphan).  The job is VALID: leave it for
                # whoever holds it now, never quarantine it as corrupt
                continue
            except OSError:
                # transient read failure (EMFILE under fd pressure, a
                # momentary EIO) on a spec we just claimed: the job is
                # almost certainly valid — submit publishes atomically —
                # so put the claim back for a later sweep instead of
                # permanently quarantining it with an exit-2 verdict.
                # If even the requeue fails, the claim stays for the
                # next janitor.
                try:
                    _dio.rename(dst, src)
                    self._drop_lease(job_id)
                except OSError:
                    pass
            except ValueError as e:
                self.finish(job_id, verdict=None, error=f"bad job spec: {e}")
        return out

    # --- claim leases -----------------------------------------------------
    def _write_lease(self, job_id: str) -> None:
        """Stamp (or renew) this process's lease on a claimed job.  Plain
        tmp-less write: the lease is advisory liveness metadata, a torn
        read is treated as no-lease (orphan) which only costs a requeue
        of an idempotent job."""
        try:
            # injected_skew_s: the skew@host<i> fault shifts the wall
            # clock THIS host stamps into cross-host-visible metadata
            # (0.0 outside the chaos drills) — the rehearsal for a fleet
            # member whose clock drifted
            from ..resilience.faults import injected_skew_s

            _dio.write_text(
                self._lease_path(job_id),
                json.dumps(
                    {
                        "pid": os.getpid(),
                        "token": _PROC_TOKEN,
                        "lease_unix": round(
                            _clk.now() + injected_skew_s(), 3
                        ),
                    }
                ),
            )
        except OSError:
            pass  # lease-less claims degrade to the pre-lease behavior

    def _drop_lease(self, job_id: str) -> None:
        try:
            _dio.unlink(self._lease_path(job_id))
        except OSError:
            pass

    def read_lease(self, job_id: str) -> Optional[dict]:
        try:
            with open(self._lease_path(job_id)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def renew_leases(self, job_ids) -> None:
        """Re-stamp the lease timestamp on in-flight claims (the daemon's
        busy-heartbeat loop calls this every few seconds while a group
        runs, so a healthy daemon's leases never approach the TTL)."""
        for job_id in job_ids:
            self._write_lease(job_id)

    def lease_orphaned(self, job_id: str,
                       lease_ttl: Optional[float] = None,
                       skew_s: Optional[float] = None) -> bool:
        """True iff a claimed job's lease marks it as abandoned: no lease
        sidecar (pre-lease claim or write failure), a dead claimer pid on
        this host, or an expired timestamp (shared-filesystem queues,
        where pids from another box LOOK dead — expiry is what finally
        frees their claims; a live same-host sibling renews well inside
        any sane TTL).  Expiry dominates everything, including our own
        pid: an expired lease means the claimer is wedged beyond its
        renewal loop (or a foreign/recycled pid merely aliases a live
        one), and requeueing an idempotent job is the safe response."""
        lease = self.read_lease(job_id)
        if lease is None:
            # grace window: a sibling writes its lease right AFTER winning
            # the claim rename, so a leaseless-but-fresh claim may be a
            # live claim mid-stamp — only a leaseless claim that has SAT
            # there is an orphan (pre-lease daemons also land here)
            try:
                age = _clk.now() - os.path.getmtime(
                    self._job_path(CLAIMED, job_id)
                )
            except OSError:
                return True  # claim vanished under us: nothing to hold
            return age > 10.0 + self._skew(skew_s)
        if lease_ttl is None:
            lease_ttl = float(
                os.environ.get("KSPEC_CLAIM_LEASE_TTL", DEFAULT_LEASE_TTL)
            )
        # the lease timestamp may come from ANOTHER host's clock: widen
        # the expiry window by the skew allowance so a live claimer whose
        # clock runs a few seconds behind ours is never stolen from
        age = _clk.now() - float(lease.get("lease_unix", 0.0))
        if age >= lease_ttl + self._skew(skew_s):
            # expiry dominates even a live pid: the busy-heartbeat loop
            # renews every few seconds, so an expired lease means the
            # claimer is wedged beyond rescue (or a foreign-host daemon
            # died and its pid merely ALIASES a live local one)
            return True
        pid = int(lease.get("pid", -1))
        if pid == os.getpid():
            # ours ONLY if the token matches too: a recycled pid from a
            # dead predecessor must read as the orphan it is, or its
            # claims sit stuck until the TTL instead of requeueing at
            # our own startup janitor
            return lease.get("token") != _PROC_TOKEN
        return not _pid_alive(pid)

    def requeue_orphans(self, lease_ttl: Optional[float] = None,
                        skew_s: Optional[float] = None) -> list:
        """Startup janitor: claims whose LEASE is orphaned (dead pid /
        expired / missing — see :meth:`lease_orphaned`) go back to
        pending/ (idempotent jobs; nothing commits before the verdict).
        A live sibling daemon's leased claims are left untouched — the
        prerequisite for two daemons sharing one queue directory.
        ``skew_s`` threads an explicit allowance through every expiry
        decision of this sweep (see :meth:`lease_orphaned`)."""
        moved = []
        self._adopt_stale_requeues()
        # only forward skew_s when explicitly given: tests (and older
        # subclasses) stub lease_orphaned with the two-arg signature, and
        # the default sweep must stay call-compatible with them
        skw = {} if skew_s is None else {"skew_s": skew_s}
        for job_id in self._list(CLAIMED):
            if not self.lease_orphaned(job_id, lease_ttl=lease_ttl, **skw):
                continue
            lease = self.read_lease(job_id)
            claimed_path = self._job_path(CLAIMED, job_id)
            # TAKEOVER PROTOCOL (race-free with concurrent janitors +
            # re-claims): (1) atomically move the claim to a janitor-
            # private name — exactly one janitor can win this rename, and
            # the job is never visible in pending/ until step (4); (2)
            # RE-VERIFY the orphan decision on the lease as it is NOW —
            # between our check and the rename a sibling janitor may have
            # requeued the job and a live daemon re-claimed it (fresh
            # lease at the same path), in which case our rename just
            # grabbed LIVE work and must be undone; (3) stamp the
            # takeover attribution into the private copy (no concurrent
            # reader exists); (4) publish into pending/.
            private = claimed_path + f".requeue-{os.getpid()}"
            try:
                _dio.rename(claimed_path, private)
            except OSError:
                continue  # a sibling janitor (or a finishing daemon) won
            if not self.lease_orphaned(job_id, lease_ttl=lease_ttl, **skw):
                # stale decision: a live daemon re-claimed between our
                # check and the rename — give its claim file back
                try:
                    _dio.rename(private, claimed_path)
                except OSError:
                    pass
                continue
            spec = None
            takeover = {
                "from_pid": lease.get("pid") if lease else None,
                "by_pid": os.getpid(),
                "reason": (
                    "no-lease" if lease is None else "lease-expired"
                    if _clk.now() - float(lease.get("lease_unix", 0))
                    >= float(
                        lease_ttl
                        if lease_ttl is not None
                        else os.environ.get(
                            "KSPEC_CLAIM_LEASE_TTL",
                            DEFAULT_LEASE_TTL,
                        )
                    ) + self._skew(skew_s)
                    else "dead-pid"
                ),
                "at": round(_clk.now(), 3),
            }
            try:
                with open(private) as fh:
                    spec = json.load(fh)
                spec.setdefault("takeovers", []).append(takeover)
                atomic_write_json(private, spec)
            except (OSError, ValueError):
                pass  # attribution is best-effort; the requeue is not
            try:
                _dio.rename(private, self._job_path(PENDING, job_id))
                self._drop_lease(job_id)
                moved.append(job_id)
            except OSError:
                pass
            else:
                # crash adoption is an ANNOTATION on the job's one trace,
                # not a new trace: the context rode inside the spec
                fleettrace.emit_event(
                    self.dir,
                    spec.get("trace") if isinstance(spec, dict) else None,
                    "queue-requeue", job_id=job_id,
                    from_pid=takeover["from_pid"],
                    by_pid=takeover["by_pid"],
                    reason=takeover["reason"],
                )
        # dangling leases (spec vanished mid-claim, or retired without
        # cleanup by an older daemon) are dead weight: sweep them
        try:
            for name in os.listdir(os.path.join(self.queue_dir, CLAIMED)):
                if not name.endswith(".lease"):
                    continue
                jid = name[: -len(".lease")]
                if not os.path.isfile(self._job_path(CLAIMED, jid)):
                    self._drop_lease(jid)
        except OSError:
            pass
        return moved

    def _adopt_stale_requeues(self) -> None:
        """Recovery sweep for the takeover protocol: a janitor that died
        between the private rename and the pending publish leaves
        `claimed/<id>.json.requeue-<pid>`.  A later janitor adopts it —
        once the stamping pid is dead — by finishing the publish (the
        spec already carries the takeover stamp, or is still valid
        without one)."""
        try:
            names = os.listdir(os.path.join(self.queue_dir, CLAIMED))
        except OSError:
            return
        for name in names:
            if ".json.requeue-" not in name:
                continue
            job_id, _, pid_s = name.rpartition(".requeue-")
            job_id = job_id[: -len(".json")]
            try:
                if _pid_alive(int(pid_s)):
                    continue  # that janitor is mid-protocol: leave it
            except ValueError:
                continue
            try:
                _dio.rename(
                    os.path.join(self.queue_dir, CLAIMED, name),
                    self._job_path(PENDING, job_id),
                )
                self._drop_lease(job_id)
            except OSError:
                pass

    def finish(self, job_id: str, verdict: Optional[dict],
               error: Optional[str] = None) -> None:
        """Publish the verdict (atomic) THEN retire the claim: a crash
        between the two leaves a claimed job with a verdict, which the
        janitor requeues and the daemon then short-circuits on the
        existing result (execute-at-most-once for the visible verdict)."""
        if verdict is None:
            from .verdict import error_verdict

            verdict = error_verdict(error or "unknown failure")
            verdict["job_id"] = job_id
        atomic_write_json(self.result_path(job_id), verdict)
        claimed = self._job_path(CLAIMED, job_id)
        if os.path.isfile(claimed):
            try:
                _dio.rename(claimed, self._job_path(DONE, job_id))
            except OSError:
                pass
        self._drop_lease(job_id)
