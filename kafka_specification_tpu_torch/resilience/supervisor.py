"""Supervised auto-resume runner (the library behind ``cli check
--resilient`` and ``scripts/torch_resilient_run.py``).

The port's own copy of the single-run half of
``kafka_specification_tpu/resilience/supervisor.py``: a watchdog that
observes progress instead of only exit codes.

- spawns the run as a child process in its own session (stdout/stderr to
  a per-attempt log when `log_dir` is set),
- watches the heartbeat JSONL file the child appends to (the engine's
  `stats_path` per-level stream): any growth counts as progress,
- kills the child's whole process group (SIGTERM, then SIGKILL) when the
  heartbeat stalls past `stall_timeout` seconds: a run wedged on the card
  hangs without exiting, which a restart loop on exit codes never notices,
  and its grandchildren must not keep the card,
- restarts it from the engine checkpoint with a bounded restart budget and
  jittered exponential backoff,
- classifies a RESOURCE_EXHAUSTED child exit (code 75: full disk or a
  breached budget, checkpointed clean; ``resilience/resources.py``)
  separately from crashes: restarting into the same full disk would
  hot-loop, so it halts with an actionable verdict, or under
  `reclaim=True` prunes the reclaim dirs and retries exactly once,
- appends one heartbeat-enveloped JSONL event per transition (start /
  stall-kill / exit / restart / resource-exhausted / reclaim /
  resource-verdict / integrity-violation / complete / give-up) to the
  event log.

The child owns its resume: the engine resumes from `checkpoint_dir`
(checksummed, keep-last-K generations; ``resilience/checkpoints.py``), so
a restart is exactly "run the same command again".  A sticky CUDA error
(``resilience/retry.py``) ends the child like any other crash, and the
restart gives it a fresh process and a fresh CUDA context.

Every timing decision goes through ``utils/clock.py``.  This module
imports no torch, directly or through its imports: the parent must never
hold a CUDA context that a wedged child could fight over.
``daemon_supervisor_config`` points the same watchdog at the serving
daemon's heartbeat (``cli serve --supervised``).  (The JAX package's fleet
half, ``FleetConfig``/``supervise_fleet``, is not ported yet.)
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Optional

from ..utils import clock as _clk
from .heartbeat import append_jsonl, heartbeat_record
from .integrity import EXIT_INTEGRITY
from .resources import EXIT_RESOURCE_EXHAUSTED, reclaim_disk


@dataclass
class SupervisorConfig:
    cmd: list
    heartbeat: Optional[str] = None  # JSONL the child appends to
    events: str = "RESILIENT_EVENTS.jsonl"
    log_dir: Optional[str] = None  # per-attempt child logs
    stall_timeout: float = 1800.0  # no heartbeat growth for this long -> kill
    max_restarts: int = 8  # restarts, not attempts (attempts = 1 + this)
    backoff_base: float = 5.0
    backoff_cap: float = 300.0
    jitter: float = 0.25
    poll: float = 0.5
    term_grace: float = 10.0  # SIGTERM -> SIGKILL grace
    env: Optional[dict] = None
    run_id: Optional[str] = None  # obs correlation key (stamped per event)
    # resource-exit policy: a child exiting EXIT_RESOURCE_EXHAUSTED ran
    # out of disk/RSS/time and checkpointed; restarting it into the same
    # full disk would hot-loop, so the supervisor either halts with an
    # actionable verdict (default) or, with reclaim=True, prunes
    # reclaim_dirs (stale tmps + rotated checkpoint generations) and
    # retries EXACTLY once
    reclaim: bool = False
    reclaim_dirs: tuple = ()
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def backoff(self, restart: int) -> float:
        d = min(self.backoff_base * 2.0 ** (restart - 1), self.backoff_cap)
        return d * (1.0 + self.jitter * self.rng.random())

    def event(self, **fields) -> None:
        """One supervisor event: heartbeat-enveloped, run_id-stamped when
        the run has one (obs run directories), appended to the log."""
        extra = {"run_id": self.run_id} if self.run_id else {}
        append_jsonl(
            self.events, heartbeat_record("supervisor", **extra, **fields)
        )


STALL_RC = -97  # synthetic rc recorded for a stall-killed attempt


def classify_exit(rc: Optional[int]) -> str:
    """The supervisor taxonomy for a supervised child's exit (the JAX
    package's, which its fleets share):

      'ok'        rc 0 — clean exit
      'resource'  rc 75 — typed RESOURCE_EXHAUSTED; restarting into the
                  same full disk would hot-loop: halt with a verdict (at
                  most one reclaim-retry)
      'integrity' rc 76 — typed INTEGRITY_VIOLATION; restartable (the
                  resume path skips chain-failed state), budget-bounded
      'stall'     the synthetic STALL_RC a watchdog stamped on a wedged
                  child it killed; restartable, budget-bounded
      'crash'     anything else — restartable, budget-bounded
    """
    if rc == 0:
        return "ok"
    if rc == EXIT_RESOURCE_EXHAUSTED:
        return "resource"
    if rc == EXIT_INTEGRITY:
        return "integrity"
    if rc == STALL_RC:
        return "stall"
    return "crash"


def _hb_size(path: Optional[str]) -> int:
    if not path:
        return 0
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _run_attempt(cfg: SupervisorConfig, attempt: int) -> int:
    """One child run: returns its exit code, or STALL_RC if stall-killed."""
    log_fh = None
    if cfg.log_dir is not None:
        os.makedirs(cfg.log_dir, exist_ok=True)
        log_fh = open(
            os.path.join(cfg.log_dir, f"attempt-{attempt:02d}.log"), "wb"
        )
    try:
        # own session/process group: a stall-kill must take down the whole
        # tree (the command may be a shell wrapper whose wedged grandchild
        # would otherwise survive, keep the card, and race the restarted
        # attempt on the checkpoint directory)
        child = subprocess.Popen(
            cfg.cmd,
            stdout=log_fh or None,
            stderr=subprocess.STDOUT if log_fh else None,
            env=cfg.env,
            start_new_session=True,
        )

        def signal_tree(sig):
            try:
                os.killpg(child.pid, sig)  # pgid == pid (new session)
            except (OSError, ProcessLookupError):
                try:
                    child.send_signal(sig)
                except (OSError, ProcessLookupError):
                    pass

        last_progress = _clk.monotonic()
        hb_size = _hb_size(cfg.heartbeat)
        while True:
            rc = child.poll()
            if rc is not None:
                return rc
            if cfg.heartbeat is None:
                # no heartbeat stream configured: the stall detector is
                # off (a constant size would read as an eternal stall and
                # kill every healthy child); only child exits matter
                _clk.sleep(cfg.poll)
                continue
            size = _hb_size(cfg.heartbeat)
            if size != hb_size:
                hb_size = size
                last_progress = _clk.monotonic()
            if _clk.monotonic() - last_progress > cfg.stall_timeout:
                cfg.event(
                    event="stall-kill",
                    attempt=attempt,
                    stall_timeout=cfg.stall_timeout,
                    heartbeat=cfg.heartbeat,
                )
                signal_tree(signal.SIGTERM)
                try:
                    child.wait(timeout=cfg.term_grace)
                except subprocess.TimeoutExpired:
                    signal_tree(signal.SIGKILL)
                    child.wait()
                return STALL_RC
            _clk.sleep(cfg.poll)
    finally:
        if log_fh is not None:
            log_fh.close()


def _resource_verdict(cfg, attempt: int, rc: int, reclaimed: bool) -> int:
    """Halt on a RESOURCE_EXHAUSTED child exit: restarting into the same
    full disk would hot-loop (each attempt re-fills what little space the
    backoff freed and dies at the same level).  The verdict event + stderr
    line tell the operator exactly what to do; the supervisor's own exit
    code stays EXIT_RESOURCE_EXHAUSTED so callers can classify too."""
    cfg.event(
        event="resource-verdict",
        attempt=attempt,
        rc=rc,
        reclaim_tried=reclaimed,
    )
    print(
        f"[supervisor] child exited RESOURCE_EXHAUSTED (rc={rc})"
        + (" after one reclaim-retry" if reclaimed else "")
        + "; NOT restarting into an unreclaimed full disk.  Free space "
        "(or raise --disk-budget), check `cli verify-checkpoint`, then "
        "re-run to resume"
        + ("" if reclaimed or cfg.reclaim else
           "; or re-run the supervisor with --reclaim for one automatic "
           "prune-and-retry")
        + f".  Events: {cfg.events}",
        file=sys.stderr,
    )
    return EXIT_RESOURCE_EXHAUSTED


def _try_reclaim(cfg, attempt: int) -> None:
    removed = reclaim_disk(cfg.reclaim_dirs)
    cfg.event(
        event="reclaim",
        attempt=attempt,
        files_removed=len(removed),
        dirs=list(cfg.reclaim_dirs),
    )


def supervise(cfg: SupervisorConfig) -> int:
    """Run cfg.cmd to success or budget exhaustion; returns the final rc.

    As in the JAX package, a child that exits 1 (a violation found) reads
    as a crash and is restarted until the budget runs out."""
    rc = None
    reclaimed = False
    attempt = 0
    restarts_used = 0
    # while-loop with explicit restart accounting (not a for-range): the
    # one --reclaim retry must happen even when the resource exit lands
    # on the final budgeted attempt; it is a different recovery lever
    # than a crash restart and never consumes the crash-restart budget
    while True:
        attempt += 1
        cfg.event(event="start", attempt=attempt, cmd=cfg.cmd)
        t0 = _clk.now()
        rc = _run_attempt(cfg, attempt)
        cfg.event(
            event="exit",
            attempt=attempt,
            rc=rc,
            seconds=round(_clk.now() - t0, 1),
        )
        if rc == 0:
            cfg.event(event="complete", attempt=attempt)
            return 0
        if rc == EXIT_RESOURCE_EXHAUSTED:
            # resource exits are NOT crashes: never burn the restart
            # budget hot-looping into the same full disk; at most one
            # reclaim-retry (--reclaim), else halt with the verdict
            cfg.event(event="resource-exhausted", attempt=attempt, rc=rc)
            if cfg.reclaim and not reclaimed:
                reclaimed = True
                _try_reclaim(cfg, attempt)
                continue
            return _resource_verdict(cfg, attempt, rc, reclaimed)
        if rc == EXIT_INTEGRITY:
            # integrity violations (exit 76) ARE restartable: the child's
            # resume path skips corrupted generations via the digest-chain
            # validators, so the restart resumes from the newest
            # CHAIN-VERIFIED generation.  Restarts stay bounded by the
            # normal budget: persistent violations must converge to a
            # give-up, never a corruption-retry hot-loop
            cfg.event(event="integrity-violation", attempt=attempt, rc=rc)
        if restarts_used >= cfg.max_restarts:
            break
        restarts_used += 1
        delay = cfg.backoff(restarts_used)
        cfg.event(
            event="restart", attempt=attempt, backoff_s=round(delay, 2)
        )
        _clk.sleep(delay)
    cfg.event(event="give-up", attempts=attempt, rc=rc)
    print(
        f"[supervisor] giving up after {attempt} attempts "
        f"(last rc={rc}); see {cfg.events}",
        file=sys.stderr,
    )
    return rc if rc not in (0, None) else 1


# --- serving-daemon supervision (`cli serve --supervised`) -----------------


def daemon_supervisor_config(
    service_dir: str,
    cmd: list,
    stall_timeout: float = 120.0,
    max_restarts: int = 8,
    env: Optional[dict] = None,
) -> SupervisorConfig:
    """SupervisorConfig for the serving daemon (``service/daemon.py``): the
    daemon appends a heartbeat line to ``<service-dir>/service/
    heartbeat.jsonl`` every few seconds even when idle (and from a thread
    while it runs a job), so a wedged daemon stalls the heartbeat and earns
    the same kill and bounded-backoff restart as a check.  A restarted
    daemon requeues the orphaned claims at startup (``service/queue.py``),
    so in-flight work survives the bounce.  A job's RESOURCE_EXHAUSTED
    exit is the job's (an exit-75 verdict), never the daemon's."""
    svc = os.path.join(service_dir, "service")
    os.makedirs(svc, exist_ok=True)
    return SupervisorConfig(
        cmd=cmd,
        heartbeat=os.path.join(svc, "heartbeat.jsonl"),
        events=os.path.join(svc, "events.jsonl"),
        log_dir=os.path.join(svc, "logs"),
        stall_timeout=stall_timeout,
        max_restarts=max_restarts,
        env=dict(env if env is not None else os.environ),
    )
