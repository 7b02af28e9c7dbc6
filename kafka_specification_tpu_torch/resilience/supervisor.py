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
daemon's heartbeat (``cli serve --supervised``), and ``supervise_fleet``
watches a whole torch.distributed fleet (below).
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


# --- fleet supervision (a multi-process torch.distributed run) --------------
#
# A sharded run over P processes is one torch.distributed group; losing any
# process wedges the rest in their next collective (they wait on a peer that
# will never answer), so the unit of recovery is the whole fleet.
# `supervise_fleet`:
#
# - launches all P processes of the job with torchrun's variables
#   (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, which
#   parallel/multihost.py reads), on a fresh port each attempt (the old
#   group dies with the fleet),
# - watches one heartbeat file per process (`<heartbeat_dir>/proc<i>.jsonl`,
#   appended every level by parallel/sharded.py under
#   KSPEC_SHARD_HEARTBEAT_DIR), so a stalled process is seen even while its
#   peers' heartbeats grow,
# - on a process's death or stall records which process and pid failed,
#   tears the WHOLE fleet down (SIGTERM to the process groups, then
#   SIGKILL), and
# - restarts the whole job under the usual bounded budget with jittered
#   backoff; the processes resume from the newest generation every shard
#   agrees on (resilience/checkpoints.py pairs the coordinator's main file
#   with every per-host part by level), as a single-process restart would.


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class FleetConfig:
    cmd: list  # one command, launched num_processes times
    num_processes: int
    events: str = "RESILIENT_EVENTS.jsonl"
    heartbeat_dir: Optional[str] = None  # per-process shard heartbeats
    log_dir: Optional[str] = None  # per-attempt, per-process child logs
    stall_timeout: float = 1800.0
    max_restarts: int = 8
    backoff_base: float = 5.0
    backoff_cap: float = 300.0
    jitter: float = 0.25
    poll: float = 0.5
    term_grace: float = 10.0
    env: Optional[dict] = None
    run_id: Optional[str] = None
    coordinator_host: str = "127.0.0.1"
    # CPU fleets (tests, rehearsals): the shards each process's default mesh
    # holds ($KSPEC_CPU_SHARDS_PER_PROC, parallel/multihost.py); None leaves
    # the environment alone
    devices_per_proc: Optional[int] = None
    # resource-exit policy, as in SupervisorConfig: one process exiting
    # EXIT_RESOURCE_EXHAUSTED (its peers wedge in the next collective and
    # are torn down) halts the fleet with a verdict, or reclaims and
    # retries exactly once under reclaim=True
    reclaim: bool = False
    reclaim_dirs: tuple = ()
    rng: random.Random = field(default_factory=random.Random, repr=False)

    backoff = SupervisorConfig.backoff
    event = SupervisorConfig.event


def _child_env(cfg: FleetConfig, proc: int, port: int) -> dict:
    env = dict(cfg.env if cfg.env is not None else os.environ)
    env["MASTER_ADDR"] = cfg.coordinator_host
    env["MASTER_PORT"] = str(port)
    env["WORLD_SIZE"] = str(cfg.num_processes)
    env["RANK"] = str(proc)
    env["LOCAL_RANK"] = str(proc)  # every process of the fleet runs on this host
    if cfg.heartbeat_dir is not None:
        env["KSPEC_SHARD_HEARTBEAT_DIR"] = cfg.heartbeat_dir
    if cfg.devices_per_proc is not None:
        env["KSPEC_CPU_SHARDS_PER_PROC"] = str(cfg.devices_per_proc)
    return env


def _signal_pg(pid: int, sig) -> None:
    try:
        os.killpg(pid, sig)  # pgid == pid (start_new_session)
    except (OSError, ProcessLookupError):
        try:
            os.kill(pid, sig)
        except (OSError, ProcessLookupError):
            pass


def _teardown_fleet(cfg: FleetConfig, children: list) -> None:
    """SIGTERM every live process group, grace, then SIGKILL: a partial
    fleet must never be left holding a card or the checkpoint directory."""
    live = [c for c in children if c is not None and c.poll() is None]
    for c in live:
        _signal_pg(c.pid, signal.SIGTERM)
    deadline = _clk.monotonic() + cfg.term_grace
    for c in live:
        while c.poll() is None and _clk.monotonic() < deadline:
            _clk.sleep(0.05)
        if c.poll() is None:
            _signal_pg(c.pid, signal.SIGKILL)
            c.wait()


def _run_fleet_attempt(cfg: FleetConfig, attempt: int) -> str:
    """One whole-fleet launch -> 'ok' | 'dead' | 'resource'.

    'resource': a process made a RESOURCE_EXHAUSTED clean exit (a full disk,
    a breached budget; resilience/resources.py); its wedged peers are torn
    down like any fleet failure, but the classification survives, so
    supervise_fleet never restarts into the full disk."""
    port = _free_port()
    if cfg.heartbeat_dir is not None:
        os.makedirs(cfg.heartbeat_dir, exist_ok=True)
    log_fhs = []
    children = []
    try:
        for i in range(cfg.num_processes):
            fh = None
            if cfg.log_dir is not None:
                os.makedirs(cfg.log_dir, exist_ok=True)
                fh = open(os.path.join(cfg.log_dir, f"attempt-{attempt:02d}-proc{i}.log"), "wb")
            log_fhs.append(fh)
            children.append(subprocess.Popen(
                cfg.cmd,
                stdout=fh or None,
                stderr=subprocess.STDOUT if fh else None,
                env=_child_env(cfg, i, port),
                start_new_session=True,
            ))
        hb_paths = [os.path.join(cfg.heartbeat_dir, f"proc{i}.jsonl")
                    if cfg.heartbeat_dir is not None else None
                    for i in range(cfg.num_processes)]
        hb_sizes = [_hb_size(p) for p in hb_paths]
        last_progress = [_clk.monotonic()] * cfg.num_processes
        done = [None] * cfg.num_processes  # rc once exited
        while True:
            now = _clk.monotonic()
            stalled = None
            for i, child in enumerate(children):
                if done[i] is not None:
                    continue
                rc = child.poll()
                if rc is not None:
                    done[i] = rc
                    continue
                if hb_paths[i] is not None:
                    size = _hb_size(hb_paths[i])
                    if size != hb_sizes[i]:
                        hb_sizes[i] = size
                        last_progress[i] = now
                    elif stalled is None and now - last_progress[i] > cfg.stall_timeout:
                        stalled = i
            # classify only after a full sweep: a peer noticing a lost
            # rc-75 process can itself die non-zero within the same poll
            # window, and child order must never let that crash mask the
            # typed exit (the restart-into-a-full-disk loop)
            failed = next((i for i, rc in enumerate(done) if rc not in (0, None)), None)
            if failed is not None and done[failed] != EXIT_RESOURCE_EXHAUSTED:
                # one more poll cycle of grace for the reverse order: the
                # peer's crash landing just before the typed exit
                _clk.sleep(cfg.poll)
                for i, child in enumerate(children):
                    if done[i] is None:
                        done[i] = child.poll()
            resource = next((i for i, rc in enumerate(done) if rc == EXIT_RESOURCE_EXHAUSTED),
                            None)
            if resource is not None:
                # a process ran out of disk, memory or time and exited typed;
                # its peers wedge in the next collective: tear down as for
                # any fleet failure, but carry the classification up
                cfg.event(event="shard-resource-exhausted", attempt=attempt, proc=resource,
                          pid=children[resource].pid, rc=done[resource])
                return "resource"
            if failed is not None:
                # a shard's process died: the rest are (or will be) wedged
                # in a collective, so the whole attempt failed
                if done[failed] == EXIT_INTEGRITY:
                    # typed integrity exit: restartable like a crash (the
                    # resume skips chain-failed generations), recorded for
                    # attribution
                    cfg.event(event="shard-integrity-violation", attempt=attempt, proc=failed,
                              pid=children[failed].pid, rc=done[failed])
                cfg.event(event="shard-exit", attempt=attempt, proc=failed,
                          pid=children[failed].pid, rc=done[failed])
                return "dead"
            if stalled is not None:
                cfg.event(event="shard-stall", attempt=attempt, proc=stalled,
                          pid=children[stalled].pid, stall_timeout=cfg.stall_timeout,
                          heartbeat=hb_paths[stalled])
                return "dead"
            if all(rc == 0 for rc in done):
                return "ok"
            _clk.sleep(cfg.poll)
    finally:
        _teardown_fleet(cfg, children)
        for fh in log_fhs:
            if fh is not None:
                fh.close()


def supervise_fleet(cfg: FleetConfig) -> int:
    """Run the whole fleet to success or budget exhaustion; 0 on success."""
    reclaimed = False
    attempt = 0
    restarts_used = 0
    # the restart accounting of supervise(): the one --reclaim retry is
    # guaranteed even on the last budgeted attempt
    while True:
        attempt += 1
        cfg.event(event="fleet-start", attempt=attempt, processes=cfg.num_processes,
                  cmd=cfg.cmd)
        t0 = _clk.now()
        status = _run_fleet_attempt(cfg, attempt)
        cfg.event(event="fleet-teardown", attempt=attempt, ok=status == "ok", status=status,
                  seconds=round(_clk.now() - t0, 1))
        if status == "ok":
            cfg.event(event="fleet-complete", attempt=attempt)
            return 0
        if status == "resource":
            # as supervise(): a resource exit never burns the restart budget
            # into a full disk; one reclaim-retry at most, else the verdict
            if cfg.reclaim and not reclaimed:
                reclaimed = True
                _try_reclaim(cfg, attempt)
                continue
            return _resource_verdict(cfg, attempt, EXIT_RESOURCE_EXHAUSTED, reclaimed)
        if restarts_used >= cfg.max_restarts:
            break
        restarts_used += 1
        delay = cfg.backoff(restarts_used)
        cfg.event(event="restart", attempt=attempt, backoff_s=round(delay, 2))
        _clk.sleep(delay)
    cfg.event(event="fleet-give-up", attempts=attempt)
    print(f"[supervisor] fleet giving up after {attempt} attempts; see {cfg.events}",
          file=sys.stderr)
    return 1
