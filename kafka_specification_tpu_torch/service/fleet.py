"""Fault-tolerant serving-daemon fleet: ``cli serve-fleet --daemons N``.

The port's own copy of ``kafka_specification_tpu/service/fleet.py``: its
events, stderr lines and exit codes are the JAX package's.  One torch-free
parent launches N ``cli serve`` children (``python -m
kafka_specification_tpu_torch.cli serve``, each on the card unless
``--cpu`` is passed through) over one service directory and keeps the
fleet serving through every failure mode the taxonomy names:

- **death** (any nonzero exit, or an unexpected clean exit): restart the
  slot with bounded jittered backoff (resilience.supervisor's policy);
  the restarted daemon's startup janitor requeues its predecessor's
  leased claims, so in-flight jobs survive the bounce.  A child that
  cannot reach the card (no CUDA, ``torch.OutOfMemoryError``) is a death
  too: the parent never relaunches it on the CPU;
- **wedge** (per-daemon heartbeat frozen past ``--stall-timeout``): kill
  the process tree (SIGTERM -> SIGKILL) and restart it; meanwhile a
  healthy sibling's periodic janitor takes the wedged daemon's claims
  over at lease expiry;
- **rc 75** (typed RESOURCE_EXHAUSTED: the daemon itself ran out of
  service-dir disk): halt that slot with a resource-verdict event, never
  hot-loop a restart into the full disk;
- **rc 76** (typed INTEGRITY_VIOLATION): restart, budget-bounded.

Autoscaling: queue depth drives the live-daemon count between ``--min``
and ``--max``.  Scale-up spawns a new instance when pending jobs exceed
``--scale-up-pending`` per live daemon; scale-down retires the
highest-numbered instance after ``--scale-down-idle`` seconds of empty
queue via a **graceful drain**: the parent touches
``service/drain/<i>``, the daemon finishes its claimed jobs, takes no
new ones, and exits 0.

Identity: each child runs with ``KSPEC_DAEMON_INSTANCE=i``: it writes
``service/heartbeat-<i>.jsonl`` / ``metrics-<i>.prom``, stamps
``instance`` into shared events, and becomes the target of the
``crash@daemon<i>:N`` / ``stall@daemon<i>`` fault sites.

Torch-free: the parent never touches the card.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Optional

from ..resilience.heartbeat import append_jsonl, heartbeat_record
from ..utils import clock as _clk
from ..resilience.supervisor import (
    SupervisorConfig,
    _hb_size,
    classify_exit,
)
from .queue import JobQueue


@dataclass
class FleetServeConfig:
    service_dir: str
    daemons: int = 2  # initial fleet size
    min_daemons: int = 1
    max_daemons: Optional[int] = None  # default: max(daemons, min)
    poll_s: float = 0.5
    stall_timeout: float = 120.0  # per-daemon heartbeat freeze -> kill
    max_restarts: int = 8  # per slot
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    jitter: float = 0.25
    term_grace: float = 10.0
    # autoscaling
    scale_interval_s: float = 5.0
    scale_up_pending: int = 4  # pending jobs per live daemon
    scale_down_idle_s: float = 60.0
    # child construction
    serve_args: tuple = ()  # extra argv appended to each `cli serve`
    # cache federation: point every daemon of this
    # fleet at a SHARED state-cache root (entries are content-addressed
    # and re-proven per read, so N hosts federate over one namespace);
    # None keeps the per-service-dir default <svc>/state-cache
    state_cache_dir: Optional[str] = None
    # host identity for the routed fleet (service/router.py): exported
    # to every daemon as KSPEC_HOST_INSTANCE, scoping the kill@host<i> /
    # partition@host<i> / skew@host<i> chaos faults to this host
    host_instance: Optional[int] = None
    env: Optional[dict] = None
    command: Optional[object] = None  # callable(instance)->argv override
    events: Optional[str] = None  # default <svc>/service/fleet-events.jsonl
    log_dir: Optional[str] = None  # default <svc>/service/logs
    rng: random.Random = field(default_factory=random.Random, repr=False)

    backoff = SupervisorConfig.backoff

    def __post_init__(self):
        if self.max_daemons is None:
            self.max_daemons = max(self.daemons, self.min_daemons)
        self.daemons = max(self.min_daemons,
                           min(self.daemons, self.max_daemons))


class _Slot:
    """One daemon instance's lifecycle state."""

    def __init__(self, instance: int):
        self.instance = instance
        self.proc: Optional[subprocess.Popen] = None
        self.log_fh = None
        self.hb_size = 0
        self.last_progress = 0.0
        self.restarts_used = 0
        self.spawn_count = 0
        self.state = "down"  # down | up | draining | halted
        self.respawn_at: Optional[float] = None  # backoff deadline


class FleetManager:
    """The blocking fleet loop (``serve_fleet`` is the entry point).
    Single-threaded by design: every child interaction is a poll."""

    def __init__(self, cfg: FleetServeConfig):
        self.cfg = cfg
        self.queue = JobQueue(cfg.service_dir)
        svc = self.queue.service_dir
        os.makedirs(svc, exist_ok=True)
        self.drain_dir = os.path.join(svc, "drain")
        os.makedirs(self.drain_dir, exist_ok=True)
        self.events_path = cfg.events or os.path.join(
            svc, "fleet-events.jsonl"
        )
        self.log_dir = cfg.log_dir or os.path.join(svc, "logs")
        self.slots: list = []
        self._stop = False
        self._next_instance = 0
        self._idle_since: Optional[float] = None
        self._last_scale = 0.0

    # --- events -----------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        try:
            append_jsonl(
                self.events_path, heartbeat_record("fleet", event=kind,
                                                   **fields)
            )
        except OSError:
            pass  # telemetry must never take the fleet down

    # --- child management -------------------------------------------------
    def _hb_path(self, instance: int) -> str:
        return os.path.join(
            self.queue.service_dir, f"heartbeat-{instance}.jsonl"
        )

    def _drain_marker(self, instance: int) -> str:
        return os.path.join(self.drain_dir, str(instance))

    def _command(self, instance: int) -> list:
        if self.cfg.command is not None:
            return list(self.cfg.command(instance))
        argv = [
            sys.executable, "-m", "kafka_specification_tpu_torch.cli",
            "serve", self.queue.dir,
        ] + list(self.cfg.serve_args)
        if self.cfg.state_cache_dir:
            argv += ["--state-cache-dir", self.cfg.state_cache_dir]
        return argv

    def _spawn(self, slot: _Slot) -> None:
        env = dict(self.cfg.env if self.cfg.env is not None else os.environ)
        env["KSPEC_DAEMON_INSTANCE"] = str(slot.instance)
        if self.cfg.host_instance is not None:
            env["KSPEC_HOST_INSTANCE"] = str(self.cfg.host_instance)
        if self.cfg.state_cache_dir:
            # command-override children (tests' stub daemons) get the
            # federation root too, even though _command wasn't consulted
            env["KSPEC_STATE_CACHE_DIR"] = self.cfg.state_cache_dir
        os.makedirs(self.log_dir, exist_ok=True)
        slot.spawn_count += 1
        if slot.log_fh is not None:
            slot.log_fh.close()
        slot.log_fh = open(
            os.path.join(
                self.log_dir,
                f"daemon{slot.instance}-spawn{slot.spawn_count:02d}.log",
            ),
            "wb",
        )
        # stale drain marker from a previous life must not instantly
        # retire the fresh daemon
        try:
            os.unlink(self._drain_marker(slot.instance))
        except OSError:
            pass
        slot.proc = subprocess.Popen(
            self._command(slot.instance),
            stdout=slot.log_fh,
            stderr=subprocess.STDOUT,
            env=env,
            start_new_session=True,  # stall-kill takes the whole tree
        )
        slot.state = "up"
        slot.respawn_at = None
        slot.hb_size = _hb_size(self._hb_path(slot.instance))
        slot.last_progress = _clk.monotonic()
        self._event(
            "daemon-start",
            instance=slot.instance,
            pid=slot.proc.pid,
            spawn=slot.spawn_count,
        )

    def _signal_tree(self, slot: _Slot, sig) -> None:
        if slot.proc is None:
            return
        try:
            os.killpg(slot.proc.pid, sig)
        except (OSError, ProcessLookupError):
            try:
                slot.proc.send_signal(sig)
            except (OSError, ProcessLookupError):
                pass

    def _kill(self, slot: _Slot) -> None:
        self._signal_tree(slot, signal.SIGTERM)
        deadline = _clk.monotonic() + self.cfg.term_grace
        while slot.proc.poll() is None and _clk.monotonic() < deadline:
            _clk.sleep(0.05)
        if slot.proc.poll() is None:
            self._signal_tree(slot, signal.SIGKILL)
            slot.proc.wait()

    def _schedule_restart(self, slot: _Slot, why: str, rc) -> None:
        """Bounded jittered backoff, or halt the slot at budget
        exhaustion.  A fleet with every slot halted gives up."""
        if slot.restarts_used >= self.cfg.max_restarts:
            slot.state = "halted"
            self._event(
                "daemon-give-up", instance=slot.instance, why=why, rc=rc,
                restarts=slot.restarts_used,
            )
            return
        slot.restarts_used += 1
        delay = self.cfg.backoff(slot.restarts_used)
        slot.state = "down"
        slot.respawn_at = _clk.monotonic() + delay
        self._event(
            "daemon-restart", instance=slot.instance, why=why, rc=rc,
            backoff_s=round(delay, 2), restarts=slot.restarts_used,
        )

    # --- per-iteration checks ---------------------------------------------
    def _reap_and_watch(self) -> None:
        now = _clk.monotonic()
        for slot in list(self.slots):  # a drained slot removes itself
            if slot.state == "down":
                if slot.respawn_at is not None and now >= slot.respawn_at:
                    self._spawn(slot)
                continue
            if slot.state == "halted" or slot.proc is None:
                continue
            rc = slot.proc.poll()
            if rc is not None:
                self._classify_exit(slot, rc)
                continue
            # wedge detection: per-daemon heartbeat growth (an idle
            # daemon still ticks every few seconds, so frozen == wedged,
            # never merely busy — service/daemon.py's contract)
            size = _hb_size(self._hb_path(slot.instance))
            if size != slot.hb_size:
                slot.hb_size = size
                slot.last_progress = now
            elif now - slot.last_progress > self.cfg.stall_timeout:
                self._event(
                    "daemon-stall", instance=slot.instance,
                    pid=slot.proc.pid,
                    stall_timeout=self.cfg.stall_timeout,
                )
                self._kill(slot)
                self._schedule_restart(slot, "stall", None)

    def _classify_exit(self, slot: _Slot, rc: int) -> None:
        """The daemon-death taxonomy (resilience.supervisor.classify_exit):
        death -> bounded restart; rc-75 -> halt with a verdict (never
        restart into a full disk); rc-76 -> bounded restart; a clean
        exit is terminal only when WE asked for it (drain)."""
        kind = classify_exit(rc)
        self._event(
            "daemon-exit", instance=slot.instance, rc=rc, classified=kind,
            draining=slot.state == "draining",
        )
        if slot.state == "draining" and kind == "ok":
            # graceful retirement completed (scale-down)
            try:
                os.unlink(self._drain_marker(slot.instance))
            except OSError:
                pass
            slot.state = "halted"
            self._event("fleet-scale-down", instance=slot.instance)
            if slot.log_fh is not None:
                slot.log_fh.close()
                slot.log_fh = None
            self.slots.remove(slot)
            return
        if kind == "resource":
            # the daemon ITSELF ran out of service-dir disk: restarting
            # would hot-loop into the same full disk — halt the slot
            # with the actionable verdict, keep the siblings serving
            slot.state = "halted"
            self._event(
                "daemon-resource-exhausted", instance=slot.instance, rc=rc,
            )
            print(
                f"[fleet] daemon {slot.instance} exited RESOURCE_EXHAUSTED"
                f" (rc={rc}); NOT restarting it into a full service dir — "
                "free space, then restart the fleet",
                file=sys.stderr,
            )
            return
        if kind == "integrity":
            self._event(
                "daemon-integrity-violation", instance=slot.instance, rc=rc,
            )
        # crashes, integrity exits and unexpected clean exits all
        # restart (bounded): the queue is the durable state, the
        # restarted daemon's janitor requeues its predecessor's claims
        self._schedule_restart(slot, kind, rc)

    def _autoscale(self) -> None:
        now = _clk.monotonic()
        if now - self._last_scale < self.cfg.scale_interval_s:
            return
        self._last_scale = now
        try:
            pending = self.queue.pending_count()
            claimed = self.queue.claimed_count()
        except OSError:
            return
        live = [s for s in self.slots if s.state in ("up", "down")]
        # scale UP: queue depth per live daemon over the threshold
        if (
            pending > self.cfg.scale_up_pending * max(1, len(live))
            and len(live) < self.cfg.max_daemons
        ):
            slot = _Slot(self._next_instance)
            self._next_instance += 1
            self.slots.append(slot)
            self._event(
                "fleet-scale-up", instance=slot.instance, pending=pending,
                live=len(live),
            )
            self._spawn(slot)
            self._idle_since = None
            return
        # scale DOWN: drained queue for long enough -> graceful retire
        if pending == 0 and claimed == 0:
            if self._idle_since is None:
                self._idle_since = now
            elif (
                now - self._idle_since >= self.cfg.scale_down_idle_s
                and len(live) > self.cfg.min_daemons
            ):
                victim = max(
                    (s for s in live if s.state == "up"),
                    key=lambda s: s.instance,
                    default=None,
                )
                if victim is not None:
                    victim.state = "draining"
                    with open(self._drain_marker(victim.instance), "w"):
                        pass
                    self._event(
                        "fleet-drain", instance=victim.instance,
                        idle_s=round(now - self._idle_since, 1),
                    )
                    self._idle_since = now  # one retirement per window
        else:
            self._idle_since = None

    # --- lifecycle --------------------------------------------------------
    def request_stop(self, *_a) -> None:
        self._stop = True

    def run(self) -> int:
        """Serve until stopped; 0 on a requested stop, 1 when every slot
        halted (give-up / resource verdicts — see the event log)."""
        for _ in range(self.cfg.daemons):
            slot = _Slot(self._next_instance)
            self._next_instance += 1
            self.slots.append(slot)
            self._spawn(slot)
        self._event(
            "fleet-start", daemons=self.cfg.daemons,
            min=self.cfg.min_daemons, max=self.cfg.max_daemons,
        )
        try:
            while not self._stop:
                self._reap_and_watch()
                self._autoscale()
                if self.slots and all(
                    s.state == "halted" for s in self.slots
                ):
                    self._event("fleet-give-up")
                    print(
                        "[fleet] every daemon slot halted (restart budget "
                        f"or resource verdicts); see {self.events_path}",
                        file=sys.stderr,
                    )
                    return 1
                _clk.sleep(self.cfg.poll_s)
        finally:
            for slot in self.slots:
                if slot.proc is not None and slot.proc.poll() is None:
                    self._kill(slot)
                if slot.log_fh is not None:
                    slot.log_fh.close()
            self._event("fleet-stop")
        return 0


def serve_fleet_daemons(cfg: FleetServeConfig) -> int:
    """``cli serve-fleet`` entry point: run the fleet until SIGTERM/
    SIGINT, then tear the children down and exit 0."""
    mgr = FleetManager(cfg)
    old_term = signal.signal(signal.SIGTERM, mgr.request_stop)
    old_int = signal.signal(signal.SIGINT, mgr.request_stop)
    try:
        return mgr.run()
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
