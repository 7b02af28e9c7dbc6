"""The crashcheck scenario registry: one entry per durable protocol.

Each scenario is three callables over a scratch root:

- ``setup(root)``: unrecorded preparation (directory skeletons, the
  dead host's stale heartbeat).  The tree snapshot taken after setup is
  the base every crash state is replayed onto.
- ``run(root, rec) -> ctx``: the recorded protocol steps, driven
  through the REAL production code (the queue's submit/claim/finish,
  the router's sweep, the cache's publish, ...).  ``rec.ack(label)``
  marks client-visible acknowledgement points; invariants conditioned
  on an ack apply only to crash prefixes after it.
- ``recover(root, acked, ctx) -> [violation strings]``: the protocol's
  existing recovery owner (startup janitor, lease takeover, reroute
  adoption, chain-verify-or-typed-fallback, ``verify_checkpoint_dir``,
  tolerant journal readers) run against one materialized crash state,
  followed by the protocol's convergence-invariant assertions.

Recovery runs inside the harness's crashed-process view: the recording
pid reads as dead (so ``.requeue-<pid>`` / ``.reroute-<pid>`` adoption
fires exactly as it would for a real crashed sibling) and the clock-skew
allowance is zeroed so backdated leases read as expired.

Everything here is torch-free; numpy is the heaviest import (checkpoint
and run-file payloads).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from ... import durable_io as _dio
from ...obs import fleettrace
from ...obs.tracer import read_jsonl_tolerant

_CFG = "CONSTANTS MaxId = 3"
_MODULE = "IdSequence"

PENDING, CLAIMED, DONE = "pending", "claimed", "done"


@dataclass(frozen=True)
class Scenario:
    name: str
    protocol: str
    description: str
    setup: object
    run: object
    recover: object


def _queue_mod():
    from ...service import queue

    return queue


def _job_states(q, jid) -> list:
    return [st for st in (PENDING, CLAIMED, DONE)
            if os.path.isfile(q._job_path(st, jid))]


def _strays(directory: str, needle: str) -> list:
    try:
        return [n for n in os.listdir(directory) if needle in n]
    except OSError:
        return []


def _tmp_strays(*dirs) -> list:
    out = []
    for d in dirs:
        for n in _strays(d, ".tmp"):
            if n.endswith(".tmp") or ".tmp." in n:
                out.append(os.path.join(d, n))
    return out


# --- queue: submit -> claim -> verdict ------------------------------------


def _queue_setup(root):
    _queue_mod().JobQueue(os.path.join(root, "svc"))


def _queue_run(root, rec):
    q = _queue_mod().JobQueue(os.path.join(root, "svc"))
    spec = q.submit(_CFG, _MODULE, kernel_source="hand")
    jid = spec["job_id"]
    rec.ack("submitted", job_id=jid)
    claimed = q.claim_pending()
    assert [s["job_id"] for s in claimed] == [jid]
    verdict = {"model": _MODULE, "distinct_states": 4, "diameter": 2,
               "levels": [1, 3], "violation": None, "exit_code": 0,
               "job_id": jid}
    q.finish(jid, verdict)
    rec.ack("verdict", job_id=jid)
    return {"job_id": jid, "verdict": verdict}


def _queue_recover(root, acked, ctx):
    viol = []
    jid = ctx["job_id"]
    # skew_s=0.0 explicitly: the crashed claimer is a corpse, so the
    # live-but-drifted skew allowance must not protect its lease (this
    # used to be forced through os.environ["KSPEC_CLOCK_SKEW"] — now
    # threaded as a parameter so concurrent harnesses can't race on it)
    q = _queue_mod().JobQueue(os.path.join(root, "svc"), skew_s=0.0)
    q.requeue_orphans(lease_ttl=0.0)
    states = _job_states(q, jid)
    try:
        result = q.result(jid)
    except Exception as e:  # noqa: BLE001 - any raise is a finding
        viol.append(f"result() raised {type(e).__name__}: {e}")
        result = None
    try:
        q.status(jid)
    except Exception as e:  # noqa: BLE001
        viol.append(f"status() raised {type(e).__name__}: {e}")
    if "submitted" in acked and not states and result is None:
        viol.append("acknowledged submit lost: job in no queue state "
                    "and no verdict")
    if "verdict" in acked:
        if result is None:
            viol.append("acknowledged verdict lost")
        elif result.get("exit_code") != ctx["verdict"]["exit_code"]:
            viol.append("verdict content changed after crash")
    claimed_dir = os.path.join(q.queue_dir, CLAIMED)
    leftover = _strays(claimed_dir, ".requeue-")
    if leftover:
        viol.append(f"janitor left takeover-private files: {leftover}")
    tmps = _tmp_strays(os.path.join(q.queue_dir, PENDING), claimed_dir,
                       os.path.join(q.queue_dir, DONE), q.results_dir)
    if tmps:
        viol.append(f"aged tmp orphans survived the startup janitor: "
                    f"{tmps}")
    return viol


# --- router: re-route a dead host's pending job ---------------------------


def _hb_path(host_dir: str) -> str:
    svc = os.path.join(host_dir, "service")
    os.makedirs(svc, exist_ok=True)
    return os.path.join(svc, "heartbeat-daemon.jsonl")


def _stamp_heartbeat(host_dir: str, unix: float) -> None:
    with open(_hb_path(host_dir), "a") as fh:
        fh.write(json.dumps({"kind": "daemon", "unix": round(unix, 3)})
                 + "\n")


def _router_mod():
    from ...service import router

    return router


def _router_hosts(root):
    return [os.path.join(root, "hostA"), os.path.join(root, "hostB")]


def _router_setup(root):
    hosts = _router_hosts(root)
    for h in hosts:
        _queue_mod().JobQueue(h)
    now = time.time()
    _stamp_heartbeat(hosts[0], now - 3600.0)  # host A: long dead
    _stamp_heartbeat(hosts[1], now)  # host B: alive
    qa = _queue_mod().JobQueue(hosts[0])
    spec = qa.submit(_CFG, _MODULE, kernel_source="hand")
    _router_mod().Router(os.path.join(root, "router"), hosts=hosts)
    with open(os.path.join(root, "job_id"), "w") as fh:
        fh.write(spec["job_id"])


def _router_run(root, rec):
    with open(os.path.join(root, "job_id")) as fh:
        jid = fh.read().strip()
    r = _router_mod().Router(os.path.join(root, "router"),
                             hosts=_router_hosts(root))
    swept = r.sweep()
    rec.ack("rerouted", job_id=jid, swept=swept.get("rerouted", {}))
    return {"job_id": jid}


def _router_recover(root, acked, ctx):
    viol = []
    jid = ctx["job_id"]
    hosts = _router_hosts(root)
    # a live host B keeps heart-beating at real recovery time; restamp it
    # so the pre-crash stamp's age never misclassifies the survivor
    _stamp_heartbeat(hosts[1], time.time())
    # skew_s=0.0: same corpse-gets-no-allowance rule as _queue_recover
    r = _router_mod().Router(os.path.join(root, "router"), hosts=hosts,
                             skew_s=0.0)
    r.sweep()
    copies = []
    for q in r.queues:
        for st in (PENDING, CLAIMED):
            if os.path.isfile(q._job_path(st, jid)):
                copies.append(f"{q.dir}:{st}")
        copies.extend(
            f"{q.dir}:{n}"
            for n in _strays(os.path.join(q.queue_dir, PENDING),
                             ".reroute-")
        )
    if len(copies) != 1:
        viol.append(f"expected exactly one runnable copy after recovery "
                    f"sweep, found {len(copies)}: {copies}")
    route = r.read_route(jid)
    if route is not None and route.get("job_id") != jid:
        viol.append("route record torn or mismatched after crash")
    tmps = _tmp_strays(r.routes_dir)
    if tmps:
        viol.append(f"aged route tmp orphans survived the janitor: {tmps}")
    return viol


# --- state cache: concurrent same-key publish -----------------------------


def _cache_mod():
    from ...service import state_cache

    return state_cache


def _cache_key():
    sc = _cache_mod()
    return sc.CacheKey(_MODULE, False, (("MaxId", 3),), ("TypeOk",), (),
                       False, max_depth=2)


def _toy_publish(cache, key, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    counts = [1, 3, 5]
    rows = [rng.randint(0, 50, size=(n, 2)).astype(np.uint32)
            for n in counts]
    verdict = {"model": _MODULE, "distinct_states": sum(counts),
               "diameter": 2, "levels": counts, "violation": None,
               "exit_code": 0, "states_per_sec": 1.0, "seconds": 0.1}
    ok = cache.publish(key, verdict, exact64=True, lanes=2,
                       level_rows=rows, diameter=2)
    assert ok, "toy publish refused"
    return verdict


def _cache_setup(root):
    _cache_mod().StateSpaceCache(os.path.join(root, "sc"))


def _cache_run(root, rec):
    sc = _cache_mod()
    c = sc.StateSpaceCache(os.path.join(root, "sc"))
    key = _cache_key()
    _toy_publish(c, key, seed=0)
    rec.ack("published")
    # the same-key race: a second publisher (fresh nonce) wins the
    # entry-promote last; the loser's uniquely-named artifacts become GC
    # fodder
    _toy_publish(c, key, seed=1)
    rec.ack("published2")
    return {}


def _cache_recover(root, acked, ctx):
    viol = []
    sc = _cache_mod()
    c = sc.StateSpaceCache(os.path.join(root, "sc"))
    key = _cache_key()
    try:
        hit = c.lookup(key)
    except Exception as e:  # noqa: BLE001 - lookup must degrade typed
        return [f"lookup raised {type(e).__name__}: {e} (typed "
                "cache-fallback is the only legal degradation)"]
    if hit is not None and not isinstance(hit, sc.CacheHit):
        viol.append(f"lookup returned a non-hit object: {type(hit)}")
    if acked and hit is None:
        viol.append("acknowledged publish not served (entry promote was "
                    "fsync'd + dir-fsync'd, so it must survive)")
    c.collect_garbage(key, grace_s=0.0)
    d = c._entry_dir(key)
    referenced = {"entry.json"}
    try:
        with open(os.path.join(d, "entry.json")) as fh:
            art = json.load(fh).get("artifact") or {}
        for part in ("visited", "boundary"):
            if art.get(part):
                referenced.add(art[part]["name"])
                # lookup's verify pass rebuilds a referenced run's
                # missing bloom sidecar — that sidecar is live, not
                # garbage
                referenced.add(art[part]["name"] + ".bloom")
    except (OSError, ValueError):
        pass
    try:
        leftovers = [n for n in os.listdir(d) if n not in referenced]
    except OSError:
        leftovers = []
    if leftovers:
        viol.append(f"orphan artifacts survived grace-aged GC: "
                    f"{sorted(leftovers)}")
    return viol


# --- checkpoints: save + rotate -------------------------------------------


def _ckpt_store(root):
    from ...resilience.checkpoints import CheckpointStore

    return CheckpointStore(os.path.join(root, "ck"), "state.npz",
                           ident="crashcheck", keep=2)


def _ckpt_setup(root):
    os.makedirs(os.path.join(root, "ck"), exist_ok=True)


def _ckpt_run(root, rec):
    store = _ckpt_store(root)
    for depth in (1, 2):
        store.save(depth, {"frontier": np.arange(4 * depth,
                                                 dtype=np.uint64)})
        rec.ack(f"saved{depth}", depth=depth)
    return {}


def _ckpt_recover(root, acked, ctx):
    viol = []
    from ...resilience.checkpoints import verify_checkpoint_dir

    try:
        verify_checkpoint_dir(os.path.join(root, "ck"))
    except Exception as e:  # noqa: BLE001
        viol.append(f"verify_checkpoint_dir raised {type(e).__name__}: "
                    f"{e}")
    from ...resilience.checkpoints import CheckpointCorrupt

    try:
        loaded = _ckpt_store(root).load()
    except CheckpointCorrupt:
        # load()'s documented contract: files exist but no generation
        # verifies.  Checkpoints are deliberately unfsynced (recomputable
        # progress — loss costs re-exploration, not correctness), so
        # this typed raise IS the convergent degradation for a crash
        # that tore every generation.
        return viol
    except Exception as e:  # noqa: BLE001 - only the typed raise is legal
        return viol + [f"load() raised {type(e).__name__}: {e} (a torn "
                       "generation must degrade to CheckpointCorrupt, "
                       "never crash the resume untyped)"]
    # What a successful load DOES owe: the generation it picked
    # round-trips intact — arrays match their stamped depth.
    if loaded is not None:
        main, _parts, _gen = loaded
        if int(main["frontier"].shape[0]) != 4 * int(main["depth"]):
            viol.append("load() returned a generation whose content "
                        "does not match its stamped depth")
    return viol


# --- spill runs: write + k-way merge + retire inputs ----------------------


def _spill_run(root, rec):
    from ...storage.runs import SortedRun, merge_runs, write_run

    d = os.path.join(root, "spill")
    os.makedirs(d, exist_ok=True)
    metas = []
    for i in range(2):
        fps = np.sort(
            np.arange(8, dtype=np.uint64) * np.uint64(7) + np.uint64(i)
        )
        metas.append(write_run(os.path.join(d, f"run-{i}.run"), fps))
        rec.ack(f"spilled{i}")
    runs = [SortedRun(d, m, verify=False) for m in metas]
    merged = merge_runs(runs, os.path.join(d, "merged.run"))
    rec.ack("merged")
    # adoption retires the merged inputs (storage/tiered.py's post-merge
    # unlink, driven at this layer so the protocol's op shape matches)
    for m in metas:
        _dio.unlink(os.path.join(d, m["name"]))
    rec.ack("inputs-retired")
    return {"metas": metas, "merged": merged}


def _spill_recover(root, acked, ctx):
    viol = []
    from ...storage.runs import RunCorrupt, SortedRun

    d = os.path.join(root, "spill")
    _dio.sweep_tmp(d)
    for meta in ctx["metas"] + [ctx["merged"]]:
        path = os.path.join(d, meta["name"])
        if not os.path.isfile(path):
            continue  # retired or never promoted: both legal
        try:
            run = SortedRun(d, meta, verify=True)
            run.arr._mmap.close()
        except RunCorrupt as e:
            viol.append(f"{meta['name']}: promoted run corrupt after "
                        f"crash ({e}) — the atomic promote must never "
                        "expose torn data")
        except Exception as e:  # noqa: BLE001
            viol.append(f"{meta['name']}: open raised "
                        f"{type(e).__name__}: {e}")
    if "merged" in acked and not os.path.isfile(
        os.path.join(d, ctx["merged"]["name"])
    ):
        viol.append("acknowledged merged run lost (its promote is "
                    "fsync'd + dir-fsync'd)")
    tmps = _tmp_strays(d)
    if tmps:
        viol.append(f"tmp orphans survived sweep_tmp: {tmps}")
    return viol


# --- sweep manifest: create, update, resume -------------------------------


def _sweep_lattice():
    from ...sweep.lattice import Axis, LatticeSheet, LatticeSpec

    sheet = LatticeSheet(module=_MODULE, cfg_text=_CFG,
                         axes=[Axis("MaxId", (2, 3))])
    return LatticeSpec(name="crashcheck", sheets=[sheet])


def _sweep_run(root, rec):
    from ...sweep.portfolio import Manifest

    d = os.path.join(root, "sweep")
    m = Manifest.open_or_create(d, _sweep_lattice())
    m.promote()
    rec.ack("manifest")
    m.rec["points"]["p0"] = {"state": "submitted", "job_id": "j0"}
    m.promote()
    rec.ack("manifest2")
    return {"sweep_id": m.rec["sweep_id"]}


def _sweep_recover(root, acked, ctx):
    viol = []
    from ...sweep.portfolio import Manifest, load_manifest

    d = os.path.join(root, "sweep")
    try:
        rec = load_manifest(d)
    except FileNotFoundError:
        rec = None
        if acked:
            viol.append("acknowledged manifest promote lost")
    except Exception as e:  # noqa: BLE001 - a torn manifest is a finding
        return [f"load_manifest raised {type(e).__name__}: {e} (the "
                "promote is atomic — a reader must never see a torn "
                "manifest)"]
    if rec is not None:
        if rec.get("sweep_id") != ctx["sweep_id"]:
            viol.append("manifest identity changed across the crash "
                        "(resume would mint duplicate jobs)")
        if "manifest2" in acked and "p0" not in rec.get("points", {}):
            viol.append("acknowledged manifest update lost")
    # crash-resume reopens the manifest: the open-time janitor must
    # collect aged promote tmps and the reopen must not raise
    try:
        Manifest.open_or_create(d, _sweep_lattice())
    except Exception as e:  # noqa: BLE001
        viol.append(f"crash-resume reopen raised {type(e).__name__}: {e}")
    tmps = _tmp_strays(d)
    if tmps:
        viol.append(f"aged manifest tmps survived the open janitor: "
                    f"{tmps}")
    return viol


# --- fleet trace journal: O_APPEND emits ----------------------------------


def _trace_run(root, rec):
    trace = fleettrace.mint_trace("job-cc", time.time())
    t0 = fleettrace.now()
    for i in range(3):
        sid = fleettrace.emit_span(
            root, trace, "job-submit" if i == 0 else "queue-claim",
            t0, fleettrace.now(), job_id="job-cc",
            span_id=trace["span_id"] if i == 0 else None,
        )
        assert sid is not None
        rec.ack(f"emitted{i}")
    fleettrace.emit_event(root, trace, "queue-requeue", job_id="job-cc",
                          from_pid=1, by_pid=2, reason="crashcheck")
    return {"trace_id": trace["trace_id"]}


def _trace_recover(root, acked, ctx):
    viol = []
    path = fleettrace.trace_path(root, "job-cc")
    try:
        recs = read_jsonl_tolerant(path)
    except Exception as e:  # noqa: BLE001 - tolerant reader, by name
        return [f"read_jsonl_tolerant raised {type(e).__name__}: {e}"]
    try:
        assembled = fleettrace.assemble(recs, job_id="job-cc")
    except Exception as e:  # noqa: BLE001
        return [f"assemble raised {type(e).__name__}: {e} on a torn "
                "journal"]
    # the journal contract: appends are best-effort telemetry (never
    # fsync'd, so even acked emits may be lost) but every SURVIVING
    # record is whole — a torn tail is dropped by the reader, never
    # half-parsed into a bogus span
    for r in recs:
        if r.get("kind") not in ("span", "event"):
            viol.append(f"torn record leaked through the tolerant "
                        f"reader: {r}")
    if assembled.get("job_id") != "job-cc":
        viol.append("assemble mangled the job identity on a torn "
                    "journal")
    return viol


SCENARIOS = (
    Scenario(
        "queue-lifecycle", "queue",
        "submit -> claim -> verdict through JobQueue; recovery = startup "
        "janitor + lease-takeover requeue.  Invariants: an acknowledged "
        "submit is never lost, an acknowledged verdict survives "
        "unchanged, no takeover-private file or aged tmp outlives the "
        "janitor.",
        _queue_setup, _queue_run, _queue_recover,
    ),
    Scenario(
        "router-reroute", "router",
        "router sweep moves a dead host's pending job to a survivor via "
        "the .reroute-<pid> private-rename protocol; recovery = "
        "stale-reroute adoption + another sweep.  Invariant: exactly one "
        "runnable copy across hosts, route records never torn.",
        _router_setup, _router_run, _router_recover,
    ),
    Scenario(
        "cache-publish", "cache",
        "two same-key state-cache publishes (the cross-host race); "
        "recovery = chain-verify-or-typed-fallback lookup + grace-aged "
        "GC.  Invariants: lookup never raises and never serves a torn "
        "entry, an acknowledged publish is served, no orphan artifact "
        "survives GC.",
        _cache_setup, _cache_run, _cache_recover,
    ),
    Scenario(
        "checkpoint-save", "ckpt",
        "two checkpoint saves with generation rotation; recovery = "
        "verify_checkpoint_dir + load().  Invariant: load never crashes "
        "and never accepts a torn generation (falls back or starts "
        "fresh; checkpoints are recomputable, so loss costs work, not "
        "correctness).",
        _ckpt_setup, _ckpt_run, _ckpt_recover,
    ),
    Scenario(
        "spill-merge", "spill",
        "two spill runs, a k-way merge, input retirement (adoption's "
        "durable half); recovery = sweep_tmp + CRC verification of "
        "every surviving run.  Invariants: a promoted run is never "
        "torn, an acknowledged merge survives, no tmp survives the "
        "sweep.",
        lambda root: os.makedirs(os.path.join(root, "spill"),
                                 exist_ok=True),
        _spill_run, _spill_recover,
    ),
    Scenario(
        "sweep-manifest", "sweep",
        "sweep manifest create + update promotes; recovery = "
        "load_manifest + crash-resume reopen (open-time janitor).  "
        "Invariants: never a torn manifest, acknowledged updates "
        "survive, sweep identity is stable across the crash.",
        lambda root: None, _sweep_run, _sweep_recover,
    ),
    Scenario(
        "trace-append", "trace",
        "fleet-trace O_APPEND emits; recovery = tolerant journal read + "
        "assemble.  Invariants: a torn tail never crashes a reader or "
        "leaks a half-record into the span tree (emits are best-effort "
        "telemetry; loss is legal, corruption is not).",
        lambda root: None, _trace_run, _trace_recover,
    ),
)


def list_scenarios() -> list:
    """[{name, protocol, description}] — the registry rows ``cli faults
    --list`` renders next to the fault grammar."""
    return [
        {"name": s.name, "protocol": s.protocol,
         "description": s.description}
        for s in SCENARIOS
    ]
