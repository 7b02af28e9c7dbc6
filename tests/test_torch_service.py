"""PyTorch port: the serving plane (service/) and check()'s three seams
against the JAX package's, on the CPU, with zero tolerance: the job queue's
files after the same submit, claim and finish (ids and clocks aside), the
orphan requeue and the janitor; the same queue directory served by each
package's daemon (equal verdict records, run ids, clocks and timing
aside); check(seed=) on the three backends against the cold run and JAX's
seeded run; prepared= and collect_trace=; a batched group against its
members' solo runs and JAX's derive_member.  Models: IdSequence and
KafkaTruncateToHighWatermark 2r L2 R1 E1 (353 states)."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.service import batch as jbatch
from kafka_specification_tpu.service import queue as jqueue
from kafka_specification_tpu.service.daemon import Daemon as JDaemon
from kafka_specification_tpu.service.daemon import ServeConfig as JServeConfig
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.engine import bfs as tbfs
from kafka_specification_tpu_torch.interop import to_u32
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.service import batch as tbatch
from kafka_specification_tpu_torch.service import queue as tqueue
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.service.kernel_cache import KernelCache
from kafka_specification_tpu_torch.utils.cfg import parse_cfg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.service

THW = "KafkaTruncateToHighWatermark"
THW_CFG = """
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 1
    MaxLeaderEpoch = 1
INVARIANTS TypeOk WeakIsr
CHECK_DEADLOCK FALSE
"""
IDS_CFG = open(os.path.join(os.path.dirname(__file__), "..", "configs", "IdSequence.cfg")).read()
BACKENDS = ("device", "device-hash", "host")


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)


def tthw(invs=("TypeOk", "WeakIsr")):
    return tvariants.make_model(THW, Config(2, 2, 1, 1), invs)


@functools.lru_cache(maxsize=None)
def jthw(invs=("TypeOk", "WeakIsr")):
    """One JAX model per selection, so its jitted steps compile once."""
    return jvariants.make_model(THW, JConfig(2, 2, 1, 1), invs)


def verdict(res):
    v = res.violation
    return (res.total, res.diameter, list(res.levels),
            None if v is None else (v.invariant, v.depth, v.trace))


class ChainSpy:
    """The last LevelDigestChain a check() sealed a level of (runs without
    checkpoints save no chain): its array."""

    def __init__(self, monkeypatch, module):
        self.last = None
        real = module.LevelDigestChain.seal

        def seal(chain, depth, count):
            self.last = chain
            return real(chain, depth, count)

        monkeypatch.setattr(module.LevelDigestChain, "seal", seal)

    def array(self):
        return np.asarray(self.last.to_array())


# --- the queue --------------------------------------------------------------

CLOCKS = ("submitted_unix", "claimed_unix", "at", "lease_unix", "ts", "unix", "t0", "ms",
          "span_id", "anchor_unix", "pid", "by_pid", "from_pid", "claimer_pid", "token",
          "created_unix")


def scrub(obj):
    """A queue record with its clocks, pids and random ids taken out."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in CLOCKS}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def tree(root) -> dict:
    """rel path -> parsed JSON (scrubbed) for .json/.lease/.jsonl files, or
    None for the rest (markers)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            with open(p) as fh:
                text = fh.read()
            if name.endswith(".jsonl"):
                out[rel] = [scrub(json.loads(line)) for line in text.splitlines() if line]
            elif name.endswith((".json", ".lease")):
                out[rel] = scrub(json.loads(text))
            else:
                out[rel] = text
    return out


def _queues(tmp_path):
    return tqueue.JobQueue(str(tmp_path / "t")), jqueue.JobQueue(str(tmp_path / "j"))


def test_queue_round_trip_files_equal_jax(tmp_path):
    tq, jq = _queues(tmp_path)
    for q in (tq, jq):
        q.submit(THW_CFG, THW, tenant="acme", cfg_path="thw.cfg", kernel_source="hand",
                 max_depth=5, job_id="job-a")
        q.submit(IDS_CFG, "IdSequence", job_id="job-b", fault="crash@level:2")
    assert tree(tq.dir) == tree(jq.dir)
    assert tq.pending_for_tenant("acme") == jq.pending_for_tenant("acme") == 1
    t_specs, j_specs = tq.claim_pending(), jq.claim_pending()
    assert scrub(t_specs) == scrub(j_specs) and len(t_specs) == 2
    assert tree(tq.dir) == tree(jq.dir)
    assert tq.status("job-a")["state"] == jq.status("job-a")["state"] == "claimed"
    rec = {"schema": "kspec-verdict/1", "exit_code": 0, "job_id": "job-a"}
    for q in (tq, jq):
        q.finish("job-a", dict(rec))
        q.finish("job-b", None, error="bad job spec: x")
    assert tree(tq.dir) == tree(jq.dir)
    for job in ("job-a", "job-b"):
        assert tq.status(job) == jq.status(job)
        assert tq.result(job) == jq.result(job)
    assert tq.overview()["counts"] == jq.overview()["counts"] == {
        "pending": 0, "claimed": 0, "done": 2}


def test_orphan_requeue_and_janitor_equal_jax(tmp_path):
    """A claim whose claimer is gone goes back to pending/ with JAX's
    takeover record; a dangling lease is swept; a stale .tmp in a queue
    state directory is removed by the next JobQueue, a fresh one kept."""
    tq, jq = _queues(tmp_path)
    dead = 2 ** 22 + 12345  # above pid_max, which Linux caps at 2^22: never a live pid
    for q in (tq, jq):
        q.submit(IDS_CFG, "IdSequence", job_id="job-o")
        q.submit(IDS_CFG, "IdSequence", job_id="job-p")
        q.claim_pending()
        with open(q._lease_path("job-o"), "w") as fh:
            json.dump({"pid": dead, "token": "x", "lease_unix": 0.0 + 1e12}, fh)
        os.unlink(os.path.join(q.queue_dir, "claimed", "job-p.json"))  # dangling lease
    assert tq.requeue_orphans() == jq.requeue_orphans() == ["job-o"]
    assert tree(tq.dir) == tree(jq.dir)
    spec = json.load(open(os.path.join(tq.queue_dir, "pending", "job-o.json")))
    assert spec["takeovers"][-1]["reason"] == "dead-pid"
    assert not os.path.exists(tq._lease_path("job-p"))
    for q, mod in ((tq, tqueue), (jq, jqueue)):
        old = os.path.join(q.queue_dir, "pending", "x.json.tmp")
        new = os.path.join(q.queue_dir, "pending", "y.json.tmp")
        for p in (old, new):
            open(p, "w").close()
        os.utime(old, (1.0, 1.0))
        mod.JobQueue(q.dir)
        assert not os.path.exists(old) and os.path.exists(new)


def test_wired_daemon_sites_and_refused_host_faults(tmp_path, monkeypatch):
    """The daemon, cache and host faults are wired; a plan naming an
    unwired site (flip@exchange, the sharded engine's) is refused before
    the queue exists."""
    monkeypatch.setenv("KSPEC_FAULT", "kill@host0:1,flip@exchange:2")
    with pytest.raises(ValueError, match="not wired") as ei:
        Daemon(ServeConfig(str(tmp_path / "svc"), device="cpu"))
    assert "site(s) flip@exchange are not wired" in str(ei.value)
    assert not os.path.exists(tmp_path / "svc")  # refused before the queue exists
    monkeypatch.setenv("KSPEC_FAULT", "crash@daemon0:1,stall@daemon0,flip@cache:1,enospc@cache:2,"
                       "kill@host0:1,partition@host1:2,skew@host0:-1.5")
    Daemon(ServeConfig(str(tmp_path / "svc"), device="cpu"))


def test_daemon_refuses_to_start_without_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = tqueue.JobQueue(str(tmp_path / "svc"))
    job = q.submit(IDS_CFG, "IdSequence")["job_id"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Daemon(ServeConfig(q.dir))
    assert q.status(job)["state"] == "pending"


# --- one queue directory, both daemons ---------------------------------------

VOLATILE = ("run_id", "timing", "seconds", "states_per_sec", "leader_run_id",
            "published_unix")


def strip(rec):
    if isinstance(rec, dict):
        return {k: strip(v) for k, v in rec.items() if k not in VOLATILE}
    return rec


def test_one_queue_served_by_each_package_gives_equal_verdicts(tmp_path):
    """Jobs of two shapes, one batched group with a violation among them, a
    solo job whose deeper bound then seeds from its boundary, and a repeat
    (a state-cache hit): the port's daemon and JAX's, each on its copy of
    the queue, publish equal records."""
    base = tmp_path / "base"
    q = tqueue.JobQueue(str(base))
    first = [
        q.submit(THW_CFG, THW, kernel_source="hand", job_id="job-01")["job_id"],
        q.submit(THW_CFG.replace("TypeOk WeakIsr", "WeakIsr"), THW, job_id="job-02",
                 max_depth=5)["job_id"],
        q.submit(THW_CFG.replace("TypeOk WeakIsr", "TypeOk"), THW, job_id="job-03",
                 max_depth=4, solo=True)["job_id"],
    ]
    shutil.copytree(base, tmp_path / "t")
    shutil.copytree(base, tmp_path / "j")
    td = Daemon(ServeConfig(str(tmp_path / "t"), device="cpu", min_bucket=32, linger_s=0.0))
    jd = JDaemon(JServeConfig(str(tmp_path / "j"), min_bucket=32, linger_s=0.0))
    assert td.drain_once() == jd.drain_once() == 3
    second = {"job-05": None, "job-06": 4}
    for d in (td, jd):
        for job, md in second.items():
            d.queue.submit(THW_CFG.replace("TypeOk WeakIsr", "TypeOk"), THW, job_id=job,
                           max_depth=md)
        assert d.drain_once() == 2
    tq, jq = tqueue.JobQueue(str(tmp_path / "t")), jqueue.JobQueue(str(tmp_path / "j"))
    for job in first + list(second):
        t, j = tq.result(job), jq.result(job)
        assert strip(t) == strip(j), job
    assert tq.result("job-01")["violation"]["invariant"] == "WeakIsr"
    assert tq.result("job-01")["batch"]["group_size"] == 2
    assert tq.result("job-05")["cache"] == {"state_cache": "seed", "from_depth": 4}
    assert tq.result("job-06")["cache"]["state_cache"] == "hit"
    assert td.cache.stats()["model_layer"] == jd.cache.stats()["model_layer"]


# --- the three seams of check() ------------------------------------------------


def _seed(model_spec, levels, total, rows):
    chain = tinteg.LevelDigestChain()
    fps = []
    for d, r in enumerate(rows):
        f = tinteg.fingerprint_rows(np.ascontiguousarray(r, np.uint32), model_spec.exact64)
        chain.fold(f)
        chain.seal(d, int(levels[d]))
        fps.append(f)
    return {"visited_fps": np.sort(np.concatenate(fps)), "frontier": rows[-1],
            "levels": list(levels), "total": total, "depth": len(levels) - 1,
            "digest_chain": chain.to_array()}


def _seeded_equals_cold(backend, dev, monkeypatch):
    m = tthw(("TypeOk",))
    spy = ChainSpy(monkeypatch, tinteg)
    cold = check(m, min_bucket=32, visited_backend=backend, device=dev)
    cold_chain = spy.array()
    tr = []
    cut = check(m, min_bucket=32, max_depth=4, visited_backend=backend, collect_trace=tr,
                device=dev)
    seed = _seed(m.spec, cut.levels, cut.total, [to_u32(t[0]) for t in tr[:5]])
    seeded = check(m, min_bucket=32, visited_backend=backend, seed=seed, device=dev)
    assert (seeded.levels, seeded.total, seeded.diameter) == (cold.levels, cold.total, cold.diameter)
    assert seeded.total == 353 and seeded.stats["seeded_from_depth"] == 4
    assert np.array_equal(spy.array(), cold_chain)
    return seed, seeded, spy.array()


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_check_equals_cold_and_jax(backend, monkeypatch):
    seed, seeded, chain = _seeded_equals_cold(backend, "cpu", monkeypatch)
    jspy = ChainSpy(monkeypatch, jinteg)
    j = jbfs.check(jthw(("TypeOk",)), min_bucket=32, visited_backend=backend, seed=seed)
    assert (j.levels, j.total, j.stats["seeded_from_depth"]) == (
        seeded.levels, seeded.total, 4)
    assert np.array_equal(jspy.array(), chain)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_check_equals_cold_on_the_card(backend, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _seeded_equals_cold(backend, "cuda", monkeypatch)


def test_seed_is_refused_with_a_checkpoint_or_the_disk_tier(tmp_path):
    m = tthw(("TypeOk",))
    seed = {"visited_fps": np.zeros(1, np.uint64),
            "frontier": np.zeros((1, m.spec.num_lanes), np.uint32),
            "levels": [1], "total": 1, "depth": 0, "digest_chain": None}
    with pytest.raises(ValueError, match="mutually exclusive"):
        check(m, seed=seed, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    with pytest.raises(ValueError, match="in-RAM store"):
        check(m, seed=seed, store="disk", mem_budget=1 << 20, spill_dir=str(tmp_path / "sp"),
              device="cpu")


def test_a_corrupt_seed_frontier_is_caught_before_expansion():
    m = tthw(("TypeOk",))
    tr = []
    cut = check(m, min_bucket=32, max_depth=3, collect_trace=tr, device="cpu")
    seed = _seed(m.spec, cut.levels, cut.total, [to_u32(t[0]) for t in tr[:4]])
    bad = np.array(seed["frontier"]).copy()
    bad[0, 0] ^= 1
    seed["frontier"] = bad
    with pytest.raises(tinteg.IntegrityError):
        check(m, min_bucket=32, seed=seed, device="cpu")


def test_prepared_runs_build_no_model_and_start_at_jax_capacity():
    """The model cache builds a shape once; a prepared run feeds its final
    visited capacity back, and the second run starts there, as JAX's
    prepared runs do (the ladder's fixed point)."""
    cache = KernelCache()
    cfg = parse_cfg(THW_CFG)
    first = cache.get(THW, cfg, False, ("TypeOk", "WeakIsr"))
    again = cache.get(THW, cfg, False, ("TypeOk", "WeakIsr"))
    overlay = cache.get(THW, cfg, False, ("WeakIsr", "TypeOk"))
    assert (first["hit"], again["hit"], overlay["hit"]) == (False, True, False)
    assert again["model"] is first["model"] and overlay["overlay"]
    assert [i.name for i in overlay["model"].invariants] == ["WeakIsr", "TypeOk"]
    assert cache.stats()["model_layer"] == {"entries": 1, "builds": 1, "overlay_derives": 1}
    m, pk = tthw(("TypeOk",)), None
    jm = jthw(("TypeOk",))
    pk, jpk = tbfs.prepare(m), jbfs.prepare(jm)
    caps = []
    for _ in range(2):
        r = check(m, min_bucket=32, prepared=pk, visited_capacity_exact=pk.capacity_hint,
                  device="cpu")
        j = jbfs.check(jm, min_bucket=32, prepared=jpk, visited_capacity_exact=jpk.capacity_hint)
        pk.note_result(r)
        jpk.note_result(j)
        caps.append((r.stats["visited_capacity"], j.stats["visited_capacity"]))
        assert (pk.capacity_hint, pk.rewarm()) == (jpk.capacity_hint, 0)
    assert caps[0][0] == caps[0][1] and caps[1][0] == caps[1][1] == caps[0][0]
    with pytest.raises(ValueError, match="different model"):
        check(tthw(("TypeOk",)), prepared=pk, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_collect_trace_is_jax_trace_store(backend):
    tr, jtr = [], []
    t = check(tthw(("TypeOk",)), min_bucket=32, visited_backend=backend, collect_trace=tr,
              device="cpu")
    jbfs.check(jthw(("TypeOk",)), min_bucket=32, visited_backend=backend, collect_trace=jtr)
    assert len(tr) == len(jtr) == len(t.levels) + 1  # and the trailing empty level
    for (rows, parent, act), (jrows, jparent, jact) in zip(tr, jtr):
        assert np.array_equal(to_u32(rows), np.asarray(jrows, np.uint32))
        assert np.array_equal(parent.numpy(), np.asarray(jparent))
        assert np.array_equal(act.numpy(), np.asarray(jact))
    tr2 = [("stale",)]
    check(tthw(("TypeOk",)), min_bucket=32, store_trace=False, collect_trace=tr2, device="cpu")
    assert tr2 == []


# --- batching -----------------------------------------------------------------

MEMBERS = [("job-1", ("TypeOk", "WeakIsr"), None, None),
           ("job-2", ("WeakIsr",), 5, None),
           ("job-3", ("TypeOk",), None, 60),
           ("job-4", ("WeakIsr", "TypeOk"), 7, None)]


def _group(dev):
    members = [tbatch.Member(j, i, max_depth=d, max_states=s) for j, i, d, s in MEMBERS]
    results, shared = tbatch.run_group(tthw(), members, min_bucket=32, device=dev)
    for job, invs, md, ms in MEMBERS:
        solo = check(tthw(invs), min_bucket=32, max_depth=md, max_states=ms, device=dev)
        assert verdict(results[job]) == verdict(solo), job
    return results, shared


def test_batched_group_equals_solo_runs_and_jax_derive_member():
    results, shared = _group("cpu")
    assert results["job-1"].violation.invariant == "WeakIsr"
    assert shared.collected_bytes == sum(shared.levels) * 2 * 8  # 2 lanes, int64
    jmembers = [jbatch.Member(j, i, max_depth=d, max_states=s) for j, i, d, s in MEMBERS]
    jshared = jbatch.explore_shared(jthw(), jmembers, min_bucket=32)
    for m in jmembers:
        assert verdict(results[m.job_id]) == verdict(jbatch.derive_member(jshared, m)), m.job_id


@pytest.mark.cuda
def test_batched_group_equals_solo_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _group("cuda")
