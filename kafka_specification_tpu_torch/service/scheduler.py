"""Scheduler: group claimed jobs for batching, enforce per-tenant policy.

The port's own copy of ``kafka_specification_tpu/service/scheduler.py``.

Grouping.  Jobs coalesce into one engine run when they share a **group
key**: the model-cache shape key minus the invariant selection
(module, kernel source, canonical constants, constraints), plus tenant
and deadlock flag — i.e. *configs sharing a schema shape*.  Members of a
group may differ in invariant selection, ``max_depth`` and
``max_states``: the batch runner (service/batch.py) explores once with
the UNION of the group's invariants built in and derives every
member's verdict bit-identically from the shared exploration.  Grouping
is per-tenant so resource accounting stays exact (the model cache
already amortizes across tenants — the expensive part is shared
globally; only the per-level launches are per-tenant).

Jobs that cannot coalesce run the REAL solo engine path — a plain
``check()`` with full check_invariants/check_deadlock semantics, still
warm through the model cache: deadlock-checking jobs (the deadlock
verdict is entangled with chunk order in a way the post-hoc derivation
does not replay) and jobs carrying a fault-injection plan.

Tenancy.  ``<svc>/tenants.json`` (resilience.resources.TenantBudget)
gives each tenant disk/RSS budgets, a per-level deadline, and a
``max_pending`` admission cap.  Each job runs under a FRESH per-tenant
ResourceGovernor watching that job's run directory: a breach exits that
job typed (rc-75 verdict) without touching the daemon or sibling jobs.

Must stay torch-free (pure bookkeeping; the daemon imports the torch side).
"""

from __future__ import annotations

import os
from typing import Optional

from ..resilience.resources import (
    ResourceGovernor,
    budget_for_tenant,
    load_tenant_budgets,
)
from .kernel_cache import canonical_constants, job_invariants

# re-parse budgets at most this often (seconds): operators edit
# tenants.json under a live daemon
_BUDGET_TTL_S = 5.0


def group_key(spec: dict, cfg, emitted: bool) -> tuple:
    return (
        spec.get("tenant", "default"),
        spec["module"],
        bool(emitted),
        canonical_constants(cfg.constants),
        tuple(cfg.constraints),
        bool(cfg.check_deadlock),
    )


def solo_only(spec: dict, cfg) -> bool:
    """True when this job must run alone (see module docstring).  A
    state-cache-seeded job (daemon._consult_state_cache) also runs solo:
    the engine seed plugs into check(), not the batched runner.  A job
    submitted with ``solo: true`` (queue.submit(solo=True) — the sweep
    portfolio marks predicted-expensive points this way) is honored too:
    one huge member would otherwise drag its whole group's shared
    exploration out to ITS bounds envelope."""
    return (
        bool(cfg.check_deadlock)
        or bool(spec.get("fault"))
        or bool(spec.get("solo"))
        or bool(spec.get("_state_cache_seed"))
    )


def plan_groups(jobs: list, max_group: Optional[int] = None) -> list:
    """claimed [(spec, cfg, emitted)] -> list of groups (lists of those
    triples), submit-order preserved within and across groups.
    ``max_group`` caps group width by splitting an oversized group into
    submit-order packs (batch.pack_members): a thousand-point sweep
    sharing one schema shape must not force one exploration to the
    envelope of ALL thousand bounds — packs keep the memory-resident
    shared record (batch.py holds every level in RAM) bounded."""
    groups: dict = {}
    order: list = []
    for item in jobs:
        spec, cfg, emitted = item
        if solo_only(spec, cfg):
            order.append([item])
            continue
        key = group_key(spec, cfg, emitted)
        g = groups.get(key)
        if g is None:
            g = groups[key] = []
            order.append(g)
        g.append(item)
    if max_group is not None and max_group > 0:
        from .batch import pack_members

        packed: list = []
        for g in order:
            packed.extend(pack_members(g, max_group))
        return packed
    return order


def union_invariants(group: list) -> tuple:
    """Union of the members' invariant selections, SORTED — arrival order
    is semantically irrelevant to a shared exploration (invariants are
    built out of it; verdict derivation replays each member's own
    order by name), so sorting canonicalizes the kernel-cache shape key:
    {TypeOk, WeakIsr} hits the same cache line whichever job arrived
    first.  Solo-semantics jobs (deadlock/fault) bypass this and build
    with their own .cfg order, where first-violation order matters."""
    names: set = set()
    for spec, cfg, _em in group:
        names.update(job_invariants(spec["module"], cfg))
    return tuple(sorted(names))


class TenantPolicy:
    """Budget lookup + admission control, re-reading tenants.json with a
    small TTL so edits under a live daemon take effect."""

    def __init__(self, tenants_path: str):
        self.path = tenants_path
        self._budgets: dict = {}
        self._loaded_at = 0.0
        self._mtime = None

    def _refresh(self) -> None:
        import sys

        from ..utils import clock as _clk

        now = _clk.monotonic()
        if now - self._loaded_at < _BUDGET_TTL_S:
            return
        self._loaded_at = now
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            mtime = None
        if mtime == self._mtime:
            return
        try:
            budgets = load_tenant_budgets(self.path)
        except Exception as e:  # noqa: BLE001 — operator typo mid-edit
            # a malformed tenants.json under a LIVE daemon must not crash
            # it (the TTL reload exists precisely for live edits): keep
            # the previous budgets, warn, and retry next TTL — _mtime is
            # only advanced on success so the fix is picked up
            print(
                f"[serve] WARNING: ignoring malformed {self.path}: {e} "
                "(keeping previous tenant budgets)",
                file=sys.stderr,
            )
            return
        self._mtime = mtime
        self._budgets = budgets

    def budget(self, tenant: str):
        self._refresh()
        return budget_for_tenant(self._budgets, tenant)

    # NOTE: max_pending admission is enforced client-side at submit time
    # (utils/cli.py), where a malformed tenants.json should fail LOUDLY
    # (exit 2) rather than be tolerated like the live daemon does here.

    def governor(self, tenant: str, watch_dirs=(),
                 fault_plan=None) -> Optional[ResourceGovernor]:
        """A fresh per-job governor under the tenant's budgets, or None
        when the tenant is unbudgeted (engine falls back to env knobs).
        The job's fault plan rides along: a supplied governor replaces the
        engine's env-derived one, fault hooks included."""
        b = self.budget(tenant)
        if b is None:
            return None
        return b.governor(watch_dirs=watch_dirs, fault_plan=fault_plan)
