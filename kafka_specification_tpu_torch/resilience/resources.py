"""Resource-exhaustion governance: budgets, reclamation, typed clean exits.

The port's own copy of ``kafka_specification_tpu/resilience/resources.py``
with the per-tenant budgets of the serving plane.  Running
out of disk, memory or time is a governed, checkpointed stop, not a torn
exception:

- :class:`ResourceGovernor` — threaded through the level loop.  It tracks
  spill-dir + checkpoint-dir disk usage against ``--disk-budget``, process
  RSS against an (opt-in) RSS budget, and a per-level deadline watchdog.
  On a **soft breach** (usage past ``soft_frac`` of a budget) it counts a
  pressure event and runs the engine's reclamation callback
  (tmp janitor → eager spill-run merges → fresh checkpoint → prune
  generations → flush the deletion barrier).  On a **hard breach** it
  performs checkpoint-then-clean-exit: best-effort final checkpoint, then
  a typed :class:`ResourceExhausted`, which the CLI maps to exit code
  :data:`EXIT_RESOURCE_EXHAUSTED` — resumable after the operator frees
  space, never a torn crash.

- :class:`TenantBudget` — one tenant's budgets from the service
  directory's ``tenants.json``; the daemon runs each job under a fresh
  governor of its tenant's.

- :func:`reclaim_disk` — the supervisor's ``--reclaim`` sweep: stale
  tmp files and rotated checkpoint generations, by file name.

Budgets parse like ``--mem-budget`` (``512M``/``4G``); environment knobs:
``KSPEC_DISK_BUDGET``, ``KSPEC_RSS_BUDGET``, ``KSPEC_LEVEL_DEADLINE``
(seconds), ``KSPEC_RESOURCE_SOFT`` (soft fraction, default 0.85).

The RSS watchdog is gauge-only unless an RSS budget is explicitly
configured: ``--mem-budget`` bounds the *host fingerprint set*, not the
whole process (torch, the frontier buffers and the card's host-side state
ride on top), so breaching on it directly would stop every
legitimately-sized run.
"""

from __future__ import annotations

import errno
import os
import re
import time
from typing import Optional

# sysexits EX_TEMPFAIL: "temporary failure, retry later" — exactly the
# contract (free space / raise the budget, then resume from checkpoint).
EXIT_RESOURCE_EXHAUSTED = 75

_DISK_FULL_ERRNOS = (errno.ENOSPC, errno.EDQUOT)


class ResourceExhausted(RuntimeError):
    """Typed terminal: the run stopped because it ran OUT of something
    (disk budget, RSS budget, level deadline, ENOSPC from a writer) — not
    because it crashed.  The engine makes it a checkpoint-then-clean-exit
    whose on-disk state still passes ``cli verify-checkpoint``; the CLI
    maps it to :data:`EXIT_RESOURCE_EXHAUSTED`."""

    def __init__(self, reason: str, detail: str = "", depth=None,
                 at_boundary: bool = False):
        self.reason = reason  # disk | rss | deadline | stall | enospc
        self.detail = detail
        self.depth = depth
        # True iff raised at a level boundary (consistent, checkpointable
        # state); mid-level exhaustion resumes from the last checkpoint
        self.at_boundary = at_boundary
        super().__init__(
            f"RESOURCE_EXHAUSTED[{reason}]"
            + (f" at level {depth}" if depth is not None else "")
            + (f": {detail}" if detail else "")
        )


def is_disk_full(exc: BaseException) -> bool:
    """True for the OS-level out-of-space family (real or injected)."""
    if isinstance(exc, OSError) and exc.errno in _DISK_FULL_ERRNOS:
        return True
    return "No space left on device" in str(exc)


def parse_bytes(text) -> int:
    """'512M' / '4G' / '65536' -> bytes (mirrors storage.parse_mem_budget,
    duplicated here so this module never imports the storage package)."""
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip()
    mult = 1
    suffixes = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1].upper() in suffixes:
        mult = suffixes[s[-1].upper()]
        s = s[:-1]
    try:
        v = float(s)
    except ValueError:
        raise ValueError(f"bad byte budget {text!r} (use e.g. 512M, 4G)")
    if v <= 0:
        raise ValueError(f"byte budget must be positive, got {text!r}")
    return int(v * mult)


def dir_usage_bytes(paths) -> int:
    """Total file bytes under `paths` (nested watch dirs counted once)."""
    roots = sorted({os.path.normpath(p) for p in paths if p})
    total = 0
    for i, r in enumerate(roots):
        if any(
            r != k and r.startswith(k + os.sep) for k in roots[:i]
        ):
            continue  # nested under an earlier root: already counted
        for dirpath, _dirs, files in os.walk(r):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass  # unlinked mid-walk (deletion barrier flushing)
    return total


def rss_bytes() -> Optional[int]:
    """Current process resident set size, or None when unknowable."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:  # portable fallback: peak (not current) residency.  ru_maxrss
        # is KiB on Linux but BYTES on macOS (the platform that actually
        # takes this fallback — Linux has /proc)
        import resource
        import sys as _sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if _sys.platform == "darwin" else peak * 1024
    except Exception:
        return None


class ResourceGovernor:
    """Budget watchdog threaded through the engine's level loop.

    Call protocol:

    - ``level_begin(depth)`` — arm the per-level deadline,
    - ``poll(depth)`` — at chunk boundaries: cheap deadline check only,
    - ``level_end(depth, reclaim=..., save_hook=...)`` — at the level
      boundary (after the periodic checkpoint): export pressure gauges,
      fire the injected ``stall@level:N`` fault, run soft-breach
      reclamation, and on hard breach call ``save_hook`` (best-effort
      final checkpoint) then raise :class:`ResourceExhausted`.
    """

    def __init__(
        self,
        disk_budget=None,
        rss_budget=None,
        level_deadline=None,
        soft_frac: float = 0.85,
        watch_dirs=(),
        fault_plan=None,
    ):
        self.disk_budget = (
            None if disk_budget in (None, "") else parse_bytes(disk_budget)
        )
        self.rss_budget = (
            None if rss_budget in (None, "") else parse_bytes(rss_budget)
        )
        # NB: 0 is a real deadline ("every level is instantly late" — the
        # deterministic watchdog test), not "off"
        self.level_deadline = (
            None if level_deadline in (None, "") else float(level_deadline)
        )
        self.soft_frac = min(1.0, max(0.0, float(soft_frac)))
        self.watch_dirs = [p for p in watch_dirs if p]
        self.fault_plan = fault_plan
        self._level_t0 = None
        self._level_depth = None
        self.reclaims = 0
        self.pressure_events = 0

    @classmethod
    def from_env(cls, disk_budget=None, watch_dirs=(), fault_plan=None):
        env = os.environ
        if disk_budget is None and env.get("KSPEC_DISK_BUDGET"):
            disk_budget = env["KSPEC_DISK_BUDGET"]
        return cls(
            disk_budget=disk_budget,
            rss_budget=env.get("KSPEC_RSS_BUDGET") or None,
            level_deadline=env.get("KSPEC_LEVEL_DEADLINE", ""),
            soft_frac=float(env.get("KSPEC_RESOURCE_SOFT") or "0.85"),
            watch_dirs=watch_dirs,
            fault_plan=fault_plan,
        )

    # --- level protocol --------------------------------------------------
    def level_begin(self, depth: int) -> None:
        self._level_t0 = time.monotonic()
        self._level_depth = int(depth)

    def poll(self, depth: int) -> None:
        """Chunk-boundary check: the per-level deadline watchdog.  A level
        that outlives its deadline is a silent stall (a wedged device, IO
        collapse) — exhausted TIME is governed like exhausted space, but
        mid-level there is no consistent state to checkpoint, so the exit
        resumes from the last durable generation."""
        if self.level_deadline is None or self._level_t0 is None:
            return
        dt = time.monotonic() - self._level_t0
        if dt > self.level_deadline:
            self._event(
                "resource-exhausted", resource="deadline", depth=depth,
                level=self._level_depth, seconds=round(dt, 1),
            )
            raise ResourceExhausted(
                "deadline",
                f"level {self._level_depth} running {dt:.1f}s "
                f"> {self.level_deadline:.1f}s deadline",
                depth=depth,
            )

    def level_end(self, depth: int, reclaim=None, save_hook=None) -> None:
        from ..obs import metrics as _met  # lazy: cycle hygiene

        if self.fault_plan is not None and self.fault_plan.stalled(depth):
            self._hard(
                "stall",
                f"injected level stall at depth {depth} (KSPEC_FAULT)",
                depth,
                save_hook,
            )
        rss = rss_bytes()
        if rss is not None:
            _met.set_gauge("kspec_rss_bytes", rss)
        if self.rss_budget:
            _met.set_gauge("kspec_rss_budget_bytes", self.rss_budget)
            if rss is not None and rss > self.rss_budget:
                # reclamation cannot shrink a live process's heap — go
                # straight to the typed exit (the resumed run re-plans)
                self._hard(
                    "rss",
                    f"RSS {rss} bytes > budget {self.rss_budget}",
                    depth,
                    save_hook,
                )
            elif rss is not None and rss > self.soft_frac * self.rss_budget:
                self._pressure("rss", rss, self.rss_budget, depth)
        if not self.disk_budget:
            return
        used = dir_usage_bytes(self.watch_dirs)
        _met.set_gauge("kspec_disk_used_bytes", used)
        _met.set_gauge("kspec_disk_budget_bytes", self.disk_budget)
        if used > self.soft_frac * self.disk_budget:
            self._pressure("disk", used, self.disk_budget, depth)
            if reclaim is not None:
                before = used
                reclaim()
                self.reclaims += 1
                used = dir_usage_bytes(self.watch_dirs)
                _met.set_gauge("kspec_disk_used_bytes", used)
                _met.inc("kspec_reclaims_total")
                self._event(
                    "reclaim",
                    depth=depth,
                    freed_bytes=max(0, before - used),
                    used_bytes=used,
                )
        if used > self.disk_budget:
            self._hard(
                "disk",
                f"{used} bytes under watch > --disk-budget "
                f"{self.disk_budget}",
                depth,
                save_hook,
            )

    # --- internals -------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        from ..obs import tracer as _obs

        _obs.event(kind, **fields)

    def _pressure(self, resource: str, used: int, budget: int, depth) -> None:
        self.pressure_events += 1
        self._event(
            "resource-pressure",
            resource=resource,
            used=int(used),
            budget=int(budget),
            depth=depth,
        )

    def _hard(self, reason: str, detail: str, depth, save_hook) -> None:
        self._event(
            "resource-exhausted", resource=reason, depth=depth,
            detail=detail[:200],
        )
        if save_hook is not None:
            try:
                save_hook()  # checkpoint-then-clean-exit
            except OSError as e:
                # a genuinely full disk may refuse the final save; the
                # previously promoted generations still verify, so the
                # exit stays clean and resumable — just older
                import sys

                print(
                    f"[resources] final checkpoint save failed ({e}); "
                    f"resuming will use the previous generation",
                    file=sys.stderr,
                )
        raise ResourceExhausted(reason, detail, depth=depth, at_boundary=True)

    def stats(self) -> dict:
        return {
            "disk_budget": self.disk_budget,
            "rss_budget": self.rss_budget,
            "level_deadline": self.level_deadline,
            "reclaims": self.reclaims,
            "pressure_events": self.pressure_events,
        }


# --- per-tenant budgets (the serving daemon's governance unit) -------------
#
# `cli serve` multiplexes many tenants' checks onto one process; each
# tenant's jobs run under that tenant's OWN ResourceGovernor instance so a
# budget breach exits *that job* typed (the same RESOURCE_EXHAUSTED / rc-75
# contract as a solo run) without touching the daemon or sibling jobs.
# Budgets load from the service directory's `tenants.json`:
#
#     {"acme": {"disk_budget": "64M", "rss_budget": null,
#               "level_deadline": 30, "max_pending": 100},
#      "*":    {"disk_budget": "256M"}}
#
# "*" is the default applied to tenants with no explicit entry.  RSS is
# process-wide in an in-process daemon, so an RSS budget here is a coarse
# backstop (the whole daemon's residency is charged to the breaching
# tenant's job), documented in the JAX package's docs/service.md.


class TenantBudget:
    """Parsed per-tenant resource policy (all fields optional)."""

    def __init__(self, disk_budget=None, rss_budget=None,
                 level_deadline=None, max_pending=None, soft_frac=None):
        self.disk_budget = (
            None if disk_budget in (None, "") else parse_bytes(disk_budget)
        )
        self.rss_budget = (
            None if rss_budget in (None, "") else parse_bytes(rss_budget)
        )
        self.level_deadline = (
            None if level_deadline in (None, "") else float(level_deadline)
        )
        self.max_pending = (
            None if max_pending in (None, "") else int(max_pending)
        )
        self.soft_frac = (
            None if soft_frac in (None, "") else float(soft_frac)
        )

    @classmethod
    def from_dict(cls, d: dict) -> "TenantBudget":
        unknown = set(d) - {
            "disk_budget", "rss_budget", "level_deadline", "max_pending",
            "soft_frac",
        }
        if unknown:
            raise ValueError(f"unknown tenant-budget keys: {sorted(unknown)}")
        return cls(**d)

    def governor(self, watch_dirs=(), fault_plan=None) -> ResourceGovernor:
        """A fresh per-job governor under this tenant's budgets (fresh so
        one job's deadline timer / pressure counters never leak into the
        tenant's next job)."""
        return ResourceGovernor(
            disk_budget=self.disk_budget,
            rss_budget=self.rss_budget,
            level_deadline=self.level_deadline,
            soft_frac=0.85 if self.soft_frac is None else self.soft_frac,
            watch_dirs=watch_dirs,
            fault_plan=fault_plan,
        )


def load_tenant_budgets(path: str) -> dict:
    """Parse a tenants.json -> {tenant: TenantBudget}.  A missing file
    means no budgets (every tenant unrestricted); a malformed one is an
    error — silently ignoring a governance config would un-enforce it."""
    import json

    if not os.path.isfile(path):
        return {}
    with open(path) as fh:
        raw = json.load(fh)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected an object of tenant -> budgets")
    return {t: TenantBudget.from_dict(d or {}) for t, d in raw.items()}


def budget_for_tenant(budgets: dict, tenant: str) -> Optional[TenantBudget]:
    """Tenant's explicit budget, else the '*' default, else None."""
    return budgets.get(tenant) or budgets.get("*")


# rotated checkpoint generations: <stem>.<gen>.npz[.<part>] with gen >= 1
_GEN_RE = re.compile(r"^.+\.(\d+)\.npz(\..+)?$")


def _is_tmp_name(name: str) -> bool:
    return name.endswith(".tmp") or ".tmp." in name


def reclaim_disk(dirs, keep_gens: int = 1) -> list:
    """Operator-grade reclamation for the supervisor's ``--reclaim``
    policy: sweep stale ``.tmp`` files and prune rotated checkpoint
    generations past `keep_gens` (filename-level: never touches the
    newest generation or the disk tier's referenced run files, so the
    surviving chain still passes ``cli verify-checkpoint``).  Returns the
    removed paths.  Standard library only: it runs in the supervisor's
    parent, which imports no torch, before its single reclaim-retry."""
    removed = []
    for d in dirs:
        if not d or not os.path.isdir(d):
            continue
        for dirpath, _dirs, files in os.walk(d):
            for name in files:
                m = _GEN_RE.match(name)
                old_gen = m is not None and int(m.group(1)) >= keep_gens
                if not (_is_tmp_name(name) or old_gen):
                    continue
                p = os.path.join(dirpath, name)
                try:
                    os.unlink(p)
                    removed.append(p)
                except OSError:
                    pass
    return removed
