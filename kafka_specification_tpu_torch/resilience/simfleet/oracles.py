"""Invariant oracles over a simulated fleet run.

Each oracle judges the run against ground truth the kernel keeps on the
true (unskewed) timeline — the whole point of simulation is that the
judge sees through the skewed stamps production code must reason under.

``live-claim-stolen``      a janitor/sweep requeued a claim whose owner
                           daemon was alive, connected, holding a LANDED
                           lease renewed less than ``lease_ttl`` (true
                           seconds) ago.  Within the skew allowance the
                           widened expiry window makes this impossible;
                           seeing it means the lease math regressed.
``double-run``             a daemon claimed a job that another alive,
                           connected daemon was already executing —
                           i.e. a runnable copy was duplicated, not
                           handed over.  (A *partitioned* owner losing
                           its claim at TTL is the documented
                           at-least-once case and is exempt.)
``duplicate-runnable-copy`` a job had more than one pending/claimed
                           spec across the fleet after a step — the
                           exactly-once re-route/takeover rename
                           protocols both exist to prevent this.
``job-lost``               a job had no runnable copy, no protocol-
                           private file, and no verdict — nobody can
                           ever finish it.
``cache-torn-read``        a cache lookup raised, or served a verdict
                           that differs from the canonical verdict for
                           that key (readers must see whole entries or
                           nothing).
``missing-verdict``        after the drain a submitted job still has no
                           routed verdict.
``conflicting-verdicts``   two hosts hold different verdict content for
                           one job (identical duplicate files are the
                           accepted at-least-once residue; different
                           ones are not).
``fleet-failed-to-drain``  the bounded-liveness oracle: the fixed drain
                           protocol exhausted its rounds with work still
                           undone after every fault healed.
"""

from __future__ import annotations

import json
import os


def _violate(kernel, kind: str, job, detail: str, step=None) -> None:
    kernel.violations.append({
        "oracle": kind,
        "job": job,
        "t": round(kernel.clock.t, 3),
        "step": step if step is not None else len(kernel.events),
        "detail": detail,
    })


# --- at takeover sites ------------------------------------------------------

def check_takeover(kernel, moved: list, by: str) -> None:
    """O: live-claim-stolen.  ``moved`` is a janitor's requeued list."""
    for jid in moved:
        c = kernel.claims.get(jid)
        if not c or not c.get("landed"):
            continue  # lease never landed: documented grace degradation
        h = kernel.hosts[c["host"]]
        d = h.daemon
        if d.gen != c["gen"] or not d.alive or not d.connected:
            continue  # owner dead/partitioned: legitimate takeover
        if jid not in d.running:
            continue  # owner already finished or abandoned it
        age = kernel.clock.t - c["renewed_true"]
        if age < kernel.cfg.lease_ttl:
            _violate(
                kernel, "live-claim-stolen", jid,
                f"{by} stole {jid} from live host{c['host']} "
                f"gen{c['gen']} with a lease renewed {age:.3f}s ago "
                f"(ttl {kernel.cfg.lease_ttl}s)")


# --- at claim sites ---------------------------------------------------------

def check_claim(kernel, jid: str, host: int) -> None:
    """O: double-run.  Called before the claiming daemon starts the job.

    At-least-once execution after a GENUINE lease expiry (an executor
    that stopped renewing past the TTL, e.g. wedged or heartbeat-
    starved) is the documented contract, so the violation is scoped to
    what must never happen: a second claim while the original executor
    is alive, connected, and holding a landed lease younger than the
    TTL on the true timeline — i.e. a duplicated runnable copy or a
    stolen live claim, not a handover."""
    c = kernel.claims.get(jid)
    for (oh, ogen) in sorted(kernel.running_by.get(jid, ())):
        od = kernel.hosts[oh].daemon
        if not (od.gen == ogen and od.alive and od.connected):
            continue
        if not (c and c.get("landed")
                and c.get("host") == oh and c.get("gen") == ogen):
            continue  # lease never landed: grace-window degradation
        age = kernel.clock.t - c["renewed_true"]
        if age < kernel.cfg.lease_ttl:
            _violate(
                kernel, "double-run", jid,
                f"host{host} claimed {jid} while live+connected "
                f"host{oh} gen{ogen} still executes it under a lease "
                f"renewed {age:.3f}s ago (ttl {kernel.cfg.lease_ttl}s)")


# --- at cache-read sites ----------------------------------------------------

def check_cache_lookup(kernel, jid: str, module: str, key):
    """O: cache-torn-read.  Returns the hit (or None) for the caller."""
    from ...service import state_cache as sc

    try:
        hit = kernel.cache.lookup(key)
    except OSError:
        # an fs fault surfacing from lookup is environment, not cache
        # integrity — callers treat it as a miss and run the job; the
        # injected flaky-fs schedule hits this path on purpose
        return None
    except Exception as e:  # noqa: BLE001 - typed fallback is the contract
        _violate(kernel, "cache-torn-read", jid,
                 f"lookup raised {type(e).__name__}: {e}")
        return None
    if hit is None:
        return None
    if not isinstance(hit, sc.CacheHit):
        return None  # a seed is a miss to the stub engine
    expected = kernel._stub_verdict(module)
    got = {k: hit.verdict.get(k)
           for k in ("model", "distinct_states", "exit_code", "violation")}
    want = {k: expected.get(k)
            for k in ("model", "distinct_states", "exit_code", "violation")}
    if got != want:
        _violate(kernel, "cache-torn-read", jid,
                 f"hit served {got} where the canonical verdict is {want}")
        return None
    return hit


# --- after every step -------------------------------------------------------

def _runnable_copies(kernel, jid: str) -> list:
    out = []
    for h in kernel.hosts:
        q = h.daemon.queue
        for state in ("pending", "claimed"):
            if os.path.isfile(q._job_path(state, jid)):
                out.append(f"host{h.index}/{state}")
    return out

def _private_copies(kernel, jid: str) -> list:
    out = []
    for h in kernel.hosts:
        q = h.daemon.queue
        for state in ("pending", "claimed"):
            d = os.path.join(q.queue_dir, state)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in sorted(names):
                if (n.startswith(jid + ".json.requeue-")
                        or n.startswith(jid + ".json.reroute-")):
                    out.append(f"host{h.index}/{state}/{n}")
    return out


def _verdict_files(kernel, jid: str) -> list:
    out = []
    for h in kernel.hosts:
        p = h.daemon.queue.result_path(jid)
        if os.path.isfile(p):
            out.append(p)
    return out


def check_copies(kernel, step: int) -> None:
    """O: duplicate-runnable-copy + job-lost, between every two steps
    (each step runs whole protocol functions, so mid-protocol states
    are never observed — exactly the atomicity the rename protocols
    promise)."""
    for jid in kernel.submitted:
        copies = _runnable_copies(kernel, jid)
        if len(copies) > 1:
            _violate(kernel, "duplicate-runnable-copy", jid,
                     f"runnable in {copies}", step=step)
            continue
        if copies:
            continue
        if _verdict_files(kernel, jid) or _private_copies(kernel, jid):
            continue
        _violate(kernel, "job-lost", jid,
                 "no runnable copy, no protocol-private file, no verdict",
                 step=step)


# --- final ------------------------------------------------------------------

def check_final(kernel, drained: bool) -> None:
    """O: missing-verdict + conflicting-verdicts + fleet-failed-to-drain."""
    if not drained:
        undone = [jid for jid in kernel.submitted
                  if kernel._safe(lambda: kernel.router.result(jid))
                  is None]
        _violate(kernel, "fleet-failed-to-drain", None,
                 f"drain rounds exhausted with {sorted(undone)} undone")
    kernel._as_actor(None)
    for jid in sorted(kernel.submitted):
        routed = kernel._safe(lambda: kernel.router.result(jid))
        if routed is None:
            if drained:
                _violate(kernel, "missing-verdict", jid,
                         "drained fleet serves no verdict")
            continue
        seen = []
        for p in _verdict_files(kernel, jid):
            try:
                with open(p) as fh:
                    v = json.load(fh)
            except (OSError, ValueError) as e:
                _violate(kernel, "conflicting-verdicts", jid,
                         f"unreadable verdict file {p}: {e}")
                continue
            seen.append({k: v.get(k) for k in
                         ("model", "distinct_states", "exit_code",
                          "violation", "job_id")})
        if any(s != seen[0] for s in seen[1:]):
            _violate(kernel, "conflicting-verdicts", jid,
                     f"hosts disagree: {seen}")
