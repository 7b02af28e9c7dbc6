"""PyTorch port: the async overlap layer (``overlap.py``, the two-slot staged
chunk pipeline, background spill merges, the async checkpoint writer,
``--overlap``, the thread-ownership contracts) against the JAX package's,
with zero tolerance on everything but clocks.

Held against the JAX package: the knob's resolution; ``AsyncWorker``'s
order and error contract; the bit-identity matrix (the port with the layer
on and off, the JAX package both ways: levels, total, diameter, verdict,
trace values, the deterministic per-level stats fields and the digest
chain) on ``frl(2,2,2)`` at ``min_bucket=32, chunk_size=64`` on all three
backends, on the violating model and on the forced-spill tier with
checkpoints; resumes across the knob and the packages; the staged-chunk
bound; background merges (membership equal to the serial set's, the
reclaim's quiesce); the faults on the workers (crash@merge and a resume,
enospc@ckpt's exit 75, flip@spill's exit 76); the KSPEC_TSAN sanitizer and
the JAX package's AST checker over the port's contracts; and ``cli check
--overlap`` with ``cli report``'s overlap beat.

Where thread timing decides when a background merge is adopted (the
forced-spill tier with no fault plan), the run files may differ between
the packages and from the serial path's: there verdict, chain and
``verify_checkpoint_dir`` are compared.  With a fault plan armed the
level-start join blocks, and at one chunk a level the spill files and
the checkpoints are compared byte for byte (array by array).

Every test ends with no overlap worker of the port alive, KSPEC_OVERLAP and
KSPEC_TSAN as it found them, and nothing armed (``torch_guards``)."""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from kafka_specification_tpu import overlap as joverlap
from kafka_specification_tpu.analysis.ownership import check_module_contract
from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.resilience import resources as jres
from kafka_specification_tpu.resilience import faults as jfaults
from kafka_specification_tpu.storage import tiered as jtiered
from kafka_specification_tpu.utils.cli import main as jcli
from kafka_specification_tpu_torch import check, cli as tcli
from kafka_specification_tpu_torch import overlap as toverlap
from kafka_specification_tpu_torch.analysis import ownership as town
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.obs import report as treport
from kafka_specification_tpu_torch.obs import metrics as tmet
from kafka_specification_tpu_torch.obs import tracer as ttracer
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import faults as tfaults
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.resilience import resources as tres
from kafka_specification_tpu_torch.storage import tiered as ttiered
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.overlap

REPO = Path(__file__).resolve().parents[1]
FRL_CFG = str(REPO / "configs" / "FiniteReplicatedLog.cfg")
THW = "KafkaTruncateToHighWatermark"
KW = dict(min_bucket=32, chunk_size=64)
# the per-level stats fields that read no clock
DETERMINISTIC = ("depth", "frontier", "enabled_candidates", "new", "duplicates", "total",
                 "action_enablement")
OVERLAP_KEYS = ("enabled", "staged_chunks_peak", "sync_ckpt_io_s")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    monkeypatch.delenv("KSPEC_OVERLAP", raising=False)
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def models(kind):
    if kind == "frl":
        return jfrl.make_model(2, 2, 2), tfrl.make_model(2, 2, 2)
    if kind == "frl3":
        return jfrl.make_model(2, 2, 3), tfrl.make_model(2, 2, 3)
    inv = ("TypeOk", "WeakIsr")
    return (jvariants.make_model(THW, JConfig(2, 2, 1, 1), inv),
            tvariants.make_model(THW, Config(2, 2, 1, 1), inv))


def chain_of(ck):
    return tckpt.verify_file(os.path.join(str(ck), CHECKPOINT_BASENAME))["digest_chain"]


def lines(path):
    with open(path) as fh:
        return [{k: json.loads(line)[k] for k in DETERMINISTIC}
                for line in fh.read().splitlines()]


def tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def four_ways(kind, tmp_path, **kw):
    """The same check by the port and by the JAX package, each with the
    layer on and off, with a stats file -> {(package, on): (result, stats
    lines)}."""
    out = {}
    for pkg in ("jax", "port"):
        for on in (True, False):
            jm, tm = models(kind)
            stats = str(tmp_path / f"{pkg}-{on}.jsonl")
            extra = dict(kw)
            if "checkpoint_dir" in extra:
                extra["checkpoint_dir"] = str(tmp_path / f"ck-{pkg}-{on}")
            if pkg == "jax":
                res = jbfs.check(jm, overlap=on, stats_path=stats, **extra)
            else:
                res = check(tm, overlap=on, stats_path=stats, device="cpu", **extra)
            out[(pkg, on)] = (res, lines(stats))
    return out


# --- the knob and the worker ---------------------------------------------------------


@pytest.mark.parametrize("env", [None, "", "0", "1", "off", "on", "no", "false", " Off "])
def test_knob_resolves_as_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("KSPEC_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("KSPEC_OVERLAP", env)
    for flag in (None, True, False, "on", "off", "0", "false", "no", "1", "yes"):
        assert toverlap.overlap_enabled(flag) is joverlap.overlap_enabled(flag), (env, flag)
    assert toverlap.OVERLAP_ENV == joverlap.OVERLAP_ENV == "KSPEC_OVERLAP"
    if env is None or not env.strip():
        assert toverlap.overlap_enabled(None) is True  # default on


def _worker_transcript(mod, name):
    """One scenario on a package's AsyncWorker -> what it did, in order."""
    w = mod.AsyncWorker(name)
    seen, log = [], []
    jobs = [w.submit(f"j{i}", lambda i=i: seen.append(i) or i * 10) for i in range(5)]
    w.drain()
    log.append(("order", list(seen)))
    log.append(("results", [w.wait(j) for j in jobs]))

    def boom():
        raise OSError(28, "No space left on device (test)")

    bad = w.submit("boom", boom)
    w.submit("after", lambda: seen.append(99))
    with pytest.raises(OSError) as ei:
        w.wait(bad)  # wait re-raises this job's error
    log.append(("wait", ei.value.errno))
    w.drain()  # consumed by wait: raised exactly once
    log.append(("after", seen[-1]))
    bad2 = w.submit("boom2", boom)
    assert bad2.done.wait(timeout=30)
    with pytest.raises(OSError):
        w.poll()  # poll re-raises the oldest unraised error
    w.poll()  # and only once
    w.submit("boom3", boom)
    with pytest.raises(OSError):
        w.drain()  # drain joins, then re-raises
    w.drain()
    log.append(("pending", w.pending()))
    stats = w.stats()
    log.append(("stats", sorted(stats), stats["jobs"]))
    w.close()
    with pytest.raises(RuntimeError, match="is closed"):
        w.submit("late", lambda: None)
    w._thread.join(timeout=30)
    log.append(("alive", w._thread.is_alive()))
    return log


def test_async_worker_order_and_errors_equal_jax():
    t = _worker_transcript(toverlap, "kspec-test")
    j = _worker_transcript(joverlap, "jax-test")
    assert t == j
    assert t[0] == ("order", [0, 1, 2, 3, 4]) and ("after", 99) in t


def test_workers_under_stress_lose_no_job():
    """More workers than cores, each fed by its own submitting thread, with
    the interpreter switching threads every microsecond: every job runs
    once, in its worker's submission order, and the shared accounting
    (jobs_done, the queue) loses no update."""
    import sys

    n_workers, n_jobs = 2 * (os.cpu_count() or 4), 300
    workers = [toverlap.AsyncWorker(f"kspec-stress-{i}") for i in range(n_workers)]
    seen = [[] for _ in workers]
    errors = []

    def feed(i):
        try:
            w = workers[i]
            for j in range(n_jobs):
                w.submit(f"j{j}", lambda j=j: seen[i].append(j))
            w.drain()
        except BaseException as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeders = [threading.Thread(target=feed, args=(i,)) for i in range(n_workers)]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in feeders), "a submitter did not finish"
    finally:
        sys.setswitchinterval(old)
        toverlap.close_workers(workers, drain=False)
    assert not errors
    assert all(s == list(range(n_jobs)) for s in seen)
    assert all(w.stats()["jobs"] == n_jobs and w.pending() == 0 for w in workers)
    assert not any(w._thread.is_alive() for w in workers)


def test_worker_counters_and_close_workers_equal_jax():
    for mod in (toverlap, joverlap):
        a, b = mod.AsyncWorker("kspec-a"), mod.AsyncWorker("kspec-b")
        a.submit("x", lambda: time.sleep(0.01))
        a.drain()
        busy, blocked = mod.worker_counters((a, None, b))
        assert busy >= 0.01 and blocked >= 0.0
        b.submit("fail", lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            mod.close_workers((a, None, b), drain=True)
        mod.close_workers((a, b), drain=False)  # error paths: nothing raised
        assert not a._thread.is_alive() and not b._thread.is_alive()


# --- the bit-identity matrix ---------------------------------------------------------


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_bit_identity_matrix_backends(backend, tmp_path):
    """frl(2,2,2) with a checkpoint every level: the port on and off and
    the JAX package on and off give one verdict, one set of deterministic
    stats lines and one chain; stats["overlap"] has JAX's keys."""
    ways = four_ways("frl", tmp_path, visited_backend=backend, checkpoint_dir="x", **KW)
    (jres, jlines) = ways[("jax", False)]
    for key, (res, lns) in ways.items():
        assert verdict(res) == verdict(jres), key
        assert lns == jlines, key
        assert np.array_equal(chain_of(tmp_path / f"ck-{key[0]}-{key[1]}"),
                              chain_of(tmp_path / "ck-jax-False")), key
    for on in (True, False):
        t, j = ways[("port", on)][0].stats["overlap"], ways[("jax", on)][0].stats["overlap"]
        assert sorted(t) == sorted(j) and t["enabled"] is j["enabled"] is on
        assert t["staged_chunks_peak"] == j["staged_chunks_peak"]
        assert set(t) >= set(OVERLAP_KEYS)
        if on:
            for w in ("io_worker", "ckpt_worker"):
                assert sorted(t[w]) == sorted(j[w]) == ["blocked_s", "busy_s", "jobs"]
            assert t["ckpt_worker"]["jobs"] == j["ckpt_worker"]["jobs"] == 5
    # the in-memory level records: the stream's, and the overlap accounting
    res = ways[("port", True)][0]
    for rec in res.stats["levels"]:
        assert {"io_hidden_ms", "io_exposed_ms", "overlap_efficiency"} <= set(rec)
        assert 0.0 <= rec["overlap_efficiency"] <= 1.0


def test_bit_identity_violation_trace(tmp_path):
    """TruncateToHW 2r (WeakIsr at depth 8): the same trace, value for
    value, both ways in both packages."""
    ways = four_ways("thw", tmp_path, **KW)
    jres = ways[("jax", False)][0]
    assert not jres.ok
    for key, (res, lns) in ways.items():
        assert verdict(res) == verdict(jres), key
        assert res.violation.trace == jres.violation.trace, key
        assert res.violation.state == jres.violation.state, key
        assert lns == ways[("jax", False)][1], key
    assert (ways[("port", True)][0].stats["overlap"]["staged_chunks_peak"]
            == ways[("jax", True)][0].stats["overlap"]["staged_chunks_peak"])


@pytest.mark.parametrize("budget,runs_per_merge", [(256, "8"), (128, "2")])
def test_bit_identity_forced_spill_tier_with_checkpoints(budget, runs_per_merge, tmp_path,
                                                         monkeypatch):
    """The forced-spill tier (store="disk") with a checkpoint every level:
    at mem_budget=256 and JAX's default merge cadence (spills, no merge),
    and at 128 with a merge every 2 runs (a background merge): verdict,
    chain and both packages' verify_checkpoint_dir.  Thread timing decides
    when a background merge is adopted, so the run files are not compared
    here (see the fault-plan test below)."""
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", runs_per_merge)
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    ways = four_ways("frl", tmp_path, mem_budget=budget, store="disk", checkpoint_dir="x", **KW)
    jres = ways[("jax", False)][0]
    for key, (res, lns) in ways.items():
        ck = tmp_path / f"ck-{key[0]}-{key[1]}"
        assert verdict(res) == verdict(jres), key
        assert lns == ways[("jax", False)][1], key
        assert np.array_equal(chain_of(ck), chain_of(tmp_path / "ck-jax-False")), key
        assert tckpt.verify_checkpoint_dir(str(ck))["ok"], key
        assert jckpt.verify_checkpoint_dir(str(ck))["ok"], key
        sp = res.stats["spill"]
        assert sp["spills"] > 0 and sp["disk"] + sp["hot"] == res.total == 49, key
    t = ways[("port", True)][0].stats
    assert t["overlap"]["enabled"] and t["overlap"]["ckpt_worker"]["jobs"] == 5
    if runs_per_merge == "2":
        assert t["spill"]["merges"] > 0


def test_spill_files_and_checkpoints_equal_jax_with_a_fault_plan(tmp_path, monkeypatch):
    """With a fault plan armed (one that never fires) the level-start join
    blocks: at one chunk a level (frl(2,2,2), chunk 64) every background
    merge and checkpoint write is adopted at the same point in both
    packages, so the spill directories are equal byte for byte and the
    checkpoints array for array, the layer on in both."""
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:99")
    kw = dict(mem_budget=128, store="disk", overlap=True, **KW)
    t = check(tfrl.make_model(2, 2, 2), checkpoint_dir=str(tmp_path / "t"), device="cpu", **kw)
    j = jbfs.check(jfrl.make_model(2, 2, 2), checkpoint_dir=str(tmp_path / "j"), **kw)
    assert verdict(t) == verdict(j)
    assert t.stats["spill"] == j.stats["spill"] and t.stats["spill"]["merges"] > 0
    assert tree(tmp_path / "t" / "spill") == tree(tmp_path / "j" / "spill")
    ta = tckpt.verify_file(str(tmp_path / "t" / CHECKPOINT_BASENAME))
    ja = tckpt.verify_file(str(tmp_path / "j" / CHECKPOINT_BASENAME))
    assert sorted(ta) == sorted(ja)
    for k in ta:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k


# --- resumes across the knob and the packages ------------------------------------------


@pytest.mark.parametrize("first,second", [
    (("jax", True), ("port", False)), (("port", False), ("jax", True)),
    (("port", True), ("port", False)), (("port", False), ("port", True)),
    (("jax", False), ("port", True)), (("port", True), ("jax", False)),
])
def test_resume_across_the_knob_and_the_packages(first, second, tmp_path):
    """A checkpoint cut at depth 3 by one package with the layer one way,
    resumed by the other (or the same) with it the other way: the
    uninterrupted run's levels and chain."""
    ck = str(tmp_path / "ck")
    gold = jbfs.check(jfrl.make_model(2, 2, 2), min_bucket=32, overlap=False,
                      checkpoint_dir=str(tmp_path / "gold"))
    for (pkg, on), cut in ((first, dict(max_depth=3)), (second, {})):
        jm, tm = models("frl")
        if pkg == "jax":
            res = jbfs.check(jm, min_bucket=32, checkpoint_dir=ck, overlap=on, **cut)
        else:
            res = check(tm, min_bucket=32, checkpoint_dir=ck, overlap=on, device="cpu", **cut)
    assert verdict(res) == verdict(gold)
    assert np.array_equal(chain_of(ck), chain_of(tmp_path / "gold"))


def test_tier_resume_across_the_knob_and_the_packages(tmp_path, monkeypatch):
    """The forced-spill tier cut at depth 3 by the JAX package with the
    layer on, resumed by the port with it off; and the port's on-cut
    resumed by the JAX package off."""
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    kw = dict(mem_budget=256, store="disk", **KW)
    gold = jbfs.check(jfrl.make_model(2, 2, 2), overlap=False,
                      checkpoint_dir=str(tmp_path / "gold"), **kw)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jbfs.check(jfrl.make_model(2, 2, 2), checkpoint_dir=a, overlap=True, max_depth=3, **kw)
    ta = check(tfrl.make_model(2, 2, 2), checkpoint_dir=a, overlap=False, device="cpu", **kw)
    check(tfrl.make_model(2, 2, 2), checkpoint_dir=b, overlap=True, max_depth=3, device="cpu",
          **kw)
    jb = jbfs.check(jfrl.make_model(2, 2, 2), checkpoint_dir=b, overlap=False, **kw)
    for res, ck in ((ta, a), (jb, b)):
        assert verdict(res) == verdict(gold)
        assert np.array_equal(chain_of(ck), chain_of(tmp_path / "gold"))
        assert tckpt.verify_checkpoint_dir(ck)["ok"] and jckpt.verify_checkpoint_dir(ck)["ok"]


# --- the staged-chunk bound ------------------------------------------------------------


def test_two_slot_pipeline_never_holds_more_than_two_chunks():
    """frl(2,2,3) levels reach 81 rows: at chunk_size=32 a level has several
    chunks, so the layer stages two (JAX's peak), and none with it off."""
    jm, tm = models("frl3")
    kw = dict(min_bucket=32, chunk_size=32)
    t_on = check(tm, overlap=True, device="cpu", **kw)
    j_on = jbfs.check(jm, overlap=True, **kw)
    t_off = check(tm, overlap=False, device="cpu", **kw)
    j_off = jbfs.check(jm, overlap=False, **kw)
    assert verdict(t_on) == verdict(t_off) == verdict(j_on) == verdict(j_off)
    assert max(t_on.levels) > 32
    assert t_on.stats["overlap"]["staged_chunks_peak"] == 2 == \
        j_on.stats["overlap"]["staged_chunks_peak"]
    assert t_off.stats["overlap"]["staged_chunks_peak"] <= 1
    assert t_off.stats["overlap"]["staged_chunks_peak"] == \
        j_off.stats["overlap"]["staged_chunks_peak"]


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_staged_loop_equals_serial_with_several_chunks_a_level(backend):
    """frl(2,2,3) at chunk_size=32 on each backend: the staged loop commits
    in chunk order, so the levels, trace-free verdict and the per-level
    enablement equal the serial loop's and the JAX package's."""
    jm, tm = models("frl3")
    kw = dict(min_bucket=32, chunk_size=32, visited_backend=backend)
    t_on = check(tm, overlap=True, device="cpu", **kw)
    t_off = check(tm, overlap=False, device="cpu", **kw)
    j_on = jbfs.check(jm, overlap=True, **kw)
    assert verdict(t_on) == verdict(t_off) == verdict(j_on)
    for k in ("visited_capacity", "hash_table_capacity", "host_fpset_size"):
        assert t_on.stats.get(k) == j_on.stats.get(k), k


# --- background merges -------------------------------------------------------------------


def test_background_merge_membership_equals_serial_and_jax(tmp_path):
    rng = np.random.default_rng(11)
    fps = rng.integers(1, 2**63, size=6000, dtype=np.uint64)
    w = toverlap.AsyncWorker("kspec-io")
    ts = ttiered.TieredFpSet(str(tmp_path / "async"), mem_budget=16 * 200, runs_per_merge=2,
                             merge_worker=w)
    ref = ttiered.TieredFpSet(str(tmp_path / "sync"), mem_budget=16 * 200, runs_per_merge=2)
    jref = jtiered.TieredFpSet(str(tmp_path / "jax"), mem_budget=16 * 200, runs_per_merge=2)
    try:
        for i in range(0, fps.size, 500):
            batch = fps[i: i + 500]
            novel = ts.insert(batch)
            assert np.array_equal(novel, ref.insert(batch))
            assert np.array_equal(novel, jref.insert(batch))
        ts.quiesce()
        assert ts._merge_job is None and ts.merges > 0
        assert len(ts) == len(ref) == len(jref)
        probe = np.concatenate([fps[:100], np.array([7, 8, 9], np.uint64)])
        assert np.array_equal(ts.contains(probe), ref.contains(probe))
        assert np.array_equal(np.sort(ts.dump()), np.sort(ref.dump()))
    finally:
        w.close()


def test_reclaim_quiesces_the_merge_worker_first(tmp_path, monkeypatch):
    """An eager merge while a background merge is mid-write adopts it
    first: its inputs are never scheduled twice on the deletion barrier."""
    real_merge = ttiered.merge_runs
    started = []

    def slow_merge(rs, path, block=1 << 20, crash_hook=None):
        started.append(path)
        time.sleep(0.3)  # hold the merge mid-flight
        return real_merge(rs, path, block=block, crash_hook=crash_hook)

    monkeypatch.setattr(ttiered, "merge_runs", slow_merge)
    rng = np.random.default_rng(5)
    w = toverlap.AsyncWorker("kspec-io")
    ts = ttiered.TieredFpSet(str(tmp_path / "t"), mem_budget=16 * 50, runs_per_merge=2,
                             merge_worker=w, gc_barrier=2)
    try:
        fps = rng.integers(1, 2**63, size=400, dtype=np.uint64)
        for i in range(0, fps.size, 50):
            ts.insert(fps[i: i + 50])
        deadline = time.monotonic() + 30
        while not started and time.monotonic() < deadline:
            time.sleep(0.01)  # the worker picks the submitted merge up
        assert started, "a background merge should have started"
        ts.merge()  # the reclaim path's in-line merge
        assert ts._merge_job is None
        pending = [p for _n, p in ts.deleter.pending]
        assert len(pending) == len(set(pending)), "merge inputs scheduled twice"
        assert np.all(ts.contains(fps))
    finally:
        w.close()


def test_deletion_barrier_watermark_equals_jax(tmp_path):
    outs = []
    for mod in (ttiered, jtiered):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        paths = [str(d / f"f{i}") for i in range(5)]
        for p in paths:
            open(p, "w").close()
        dd = mod.DeferredDeleter(2)
        dd.schedule(paths[:3])
        tok = dd.mark()
        dd.schedule(paths[3:])
        dd.on_save(upto=tok)
        dd.on_save(upto=tok)
        outs.append((tok, [[n, os.path.basename(p)] for n, p in dd.pending],
                     sorted(os.listdir(d))))
    assert outs[0] == outs[1] == (3, [[2, "f3"], [2, "f4"]], ["f3", "f4"])


# --- faults on the workers -----------------------------------------------------------------


def _spilling(ck):
    return dict(min_bucket=32, chunk_size=64, mem_budget=128, store="disk", checkpoint_dir=ck)


@pytest.mark.fault
def test_crash_at_merge_fires_on_the_worker_and_resumes(tmp_path, monkeypatch):
    """crash@merge:1 raised on kspec-io surfaces at the next join as the
    serial path's InjectedCrash, in both packages; the checkpoint verifies
    and each resumes to the uninterrupted verdict and chain."""
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    gold = jbfs.check(jfrl.make_model(2, 2, 2), overlap=False,
                      **_spilling(str(tmp_path / "gold")))
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", "crash@merge:1")
    with pytest.raises(tfaults.InjectedCrash):
        check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    assert town.live_worker_threads() == []  # closed on the crash's way out
    with pytest.raises(jfaults.InjectedCrash):
        jbfs.check(jfrl.make_model(2, 2, 2), overlap=True, **_spilling(jck))
    monkeypatch.delenv("KSPEC_FAULT")
    for d in (ck, jck):
        assert tckpt.verify_checkpoint_dir(d)["ok"] and jckpt.verify_checkpoint_dir(d)["ok"]
    assert tckpt.verify_file(os.path.join(ck, CHECKPOINT_BASENAME))["depth"] == \
        tckpt.verify_file(os.path.join(jck, CHECKPOINT_BASENAME))["depth"]
    t = check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    j = jbfs.check(jfrl.make_model(2, 2, 2), overlap=True, **_spilling(jck))
    assert verdict(t) == verdict(j) == verdict(gold)
    assert np.array_equal(chain_of(ck), chain_of(tmp_path / "gold"))
    assert np.array_equal(chain_of(jck), chain_of(tmp_path / "gold"))


@pytest.mark.fault
def test_enospc_at_ckpt_on_the_writer_is_exit_75(tmp_path, monkeypatch):
    """enospc@ckpt:2 raised on kspec-ckpt: ResourceExhausted("enospc") at
    the JAX package's depth, a checkpoint both verifiers pass, and a resume
    to the uninterrupted verdict and chain."""
    gold = jbfs.check(jfrl.make_model(2, 2, 2), overlap=False,
                      **_spilling(str(tmp_path / "gold")))
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", "enospc@ckpt:2")
    with pytest.raises(tres.ResourceExhausted) as ei:
        check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    with pytest.raises(jres.ResourceExhausted) as ej:
        jbfs.check(jfrl.make_model(2, 2, 2), overlap=True, **_spilling(jck))
    monkeypatch.delenv("KSPEC_FAULT")
    assert (ei.value.reason, ei.value.depth) == (ej.value.reason, ej.value.depth)
    assert ei.value.reason == "enospc"
    assert sorted(os.listdir(ck)) == sorted(os.listdir(jck))
    assert tckpt.verify_checkpoint_dir(ck)["ok"] and jckpt.verify_checkpoint_dir(ck)["ok"]
    t = check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    assert verdict(t) == verdict(gold)
    assert np.array_equal(chain_of(ck), chain_of(tmp_path / "gold"))


def _strip_record(out):
    rec = json.loads(out.strip().splitlines()[-1])
    return {k: v for k, v in rec.items() if k not in ("seconds", "states_per_sec", "run_id")}


def _clis(argv_port, argv_jax, capsys):
    outs = []
    for main, argv in ((tcli.main, argv_port), (jcli, argv_jax)):
        try:
            rc = main(argv)
        finally:
            os.environ.pop("KSPEC_FAULT", None)  # --fault exports it
        outs.append((rc, capsys.readouterr()))
    return outs


@pytest.mark.fault
def test_cli_enospc_at_ckpt_record_equals_jax(tmp_path, capsys):
    common = [FRL_CFG, "--min-bucket", "32", "--json", "--overlap", "on", "--cpu",
              "--fault", "enospc@ckpt:2"]
    (rc, out), (jrc, jout) = _clis(
        ["check", *common, "--checkpoint", str(tmp_path / "ck")],
        ["check", *common, "--hand", "--checkpoint", str(tmp_path / "jck"), "--run-dir",
         str(tmp_path / "jrun")], capsys)
    assert rc == jrc == 75
    assert _strip_record(out.out) == _strip_record(jout.out)
    assert _strip_record(out.out)["error"].startswith("RESOURCE_EXHAUSTED[enospc]")
    assert tcli.main(["verify-checkpoint", str(tmp_path / "ck"), "--json"]) == 0
    capsys.readouterr()


@pytest.mark.fault
def test_flip_at_spill_caught_with_background_merges(tmp_path, monkeypatch, capsys):
    """flip@spill:1 with background merges on: IntegrityError at the JAX
    package's site and depth, and `cli check` exit 76 with JAX's record;
    the resume is exact."""
    gold = jbfs.check(jfrl.make_model(2, 2, 2), overlap=False,
                      **_spilling(str(tmp_path / "gold")))
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    monkeypatch.setenv("KSPEC_FAULT", "flip@spill:1")
    with pytest.raises(tinteg.IntegrityError) as ei:
        check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    with pytest.raises(jinteg.IntegrityError) as ej:
        jbfs.check(jfrl.make_model(2, 2, 2), overlap=True, **_spilling(jck))
    monkeypatch.delenv("KSPEC_FAULT")
    assert (ei.value.site, ei.value.depth) == (ej.value.site, ej.value.depth)
    t = check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu", **_spilling(ck))
    assert verdict(t) == verdict(gold)
    common = [FRL_CFG, "--min-bucket", "32", "--chunk-size", "64", "--mem-budget", "128",
              "--json", "--overlap", "on", "--cpu", "--fault", "flip@spill:1"]
    (rc, out), (jrc, jout) = _clis(
        ["check", *common, "--checkpoint", str(tmp_path / "ck2")],
        ["check", *common, "--hand", "--checkpoint", str(tmp_path / "jck2"), "--run-dir",
         str(tmp_path / "jrun")], capsys)
    assert rc == jrc == 76
    trec, jrec = _strip_record(out.out), _strip_record(jout.out)
    jrec["error"] = jrec["error"].replace(str(tmp_path / "jck2"), str(tmp_path / "ck2"))
    assert trec == jrec and trec["error"].startswith("INTEGRITY_VIOLATION[storage]")


def test_no_worker_outlives_a_crashed_check(tmp_path, monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:2")
    with pytest.raises(tfaults.InjectedCrash):
        check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu",
              checkpoint_dir=str(tmp_path / "ck"), **KW)
    assert town.live_worker_threads() == []
    assert not [t for t in threading.enumerate()
                if t.name in ("kspec-io", "kspec-ckpt") and t.ident in town._WORKER_THREADS]
    ttracer.set_tracer(None)
    tmet.set_registry(None)


# --- the ownership contracts -------------------------------------------------------------


@pytest.mark.parametrize("rel", ["overlap.py", "storage/tiered.py", "resilience/checkpoints.py"])
def test_jax_ast_checker_finds_nothing_in_the_port_and_contracts_equal(rel):
    """No HIGH or MEDIUM finding, and the contracts are JAX's."""
    import importlib

    findings = check_module_contract(str(REPO / "kafka_specification_tpu_torch" / rel), rel)
    assert not [f for f in findings if f.severity in ("HIGH", "MEDIUM")], findings
    name = rel[:-3].replace("/", ".")
    tmod = importlib.import_module("kafka_specification_tpu_torch." + name)
    jmod = importlib.import_module("kafka_specification_tpu." + name)
    assert tmod.THREAD_CONTRACT == jmod.THREAD_CONTRACT


def test_tsan_tier_run_with_checkpoints_raises_nothing(tmp_path, monkeypatch):
    """KSPEC_TSAN=1, armed inside the test: a forced-spill tier run with
    background merges and async checkpoints writes every attribute as its
    contract says."""
    monkeypatch.setenv("KSPEC_TSAN", "1")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    assert town.tsan_enabled()
    try:
        assert town.arm_all() == 5
        assert town.armed() == ["AsyncJob", "AsyncWorker", "CheckpointStore",
                                "DeferredDeleter", "TieredFpSet"]
        res = check(tfrl.make_model(2, 2, 2), overlap=True, device="cpu",
                    **_spilling(str(tmp_path / "ck")))
        assert res.ok and res.total == 49 and res.stats["spill"]["merges"] > 0
    finally:
        town.disarm_all()
    assert town.armed() == []


def test_tsan_catches_an_engine_only_write_from_a_worker(tmp_path, monkeypatch):
    monkeypatch.setenv("KSPEC_TSAN", "1")
    w = None
    try:
        town.arm_all()
        ts = ttiered.TieredFpSet(str(tmp_path / "t"), mem_budget=1024)
        w = toverlap.AsyncWorker("kspec-io")
        job = w.submit("bad", lambda: setattr(ts, "runs", []))
        with pytest.raises(town.OwnershipViolation, match="engine-thread-only"):
            w.wait(job)
        ts.runs = []  # the engine thread may
        with pytest.raises(town.OwnershipViolation, match="immutable-after-init"):
            ts.dir = "elsewhere"
    finally:
        if w is not None:
            w.close()
        town.disarm_all()


# --- the CLI and the report --------------------------------------------------------------


@pytest.mark.parametrize("flag", ["on", "off"])
def test_cli_overlap_record_and_report_beat_equal_jax(flag, tmp_path, capsys):
    """`cli check --overlap on|off --json` of both CLIs on the forced-spill
    tier with checkpoints: the same record; then `cli report` of each
    package on each run directory shows the overlap beat, its clock-free
    parts equal."""
    common = [FRL_CFG, "--min-bucket", "32", "--mem-budget", "300", "--json", "--overlap",
              flag, "--cpu"]
    td, jd = tmp_path / "port", tmp_path / "jax"
    (rc, out), (jrc, jout) = _clis(
        ["check", *common, "--checkpoint", str(tmp_path / "ck"), "--run-dir", str(td)],
        ["check", *common, "--hand", "--checkpoint", str(tmp_path / "jck"), "--run-dir",
         str(jd)], capsys)
    assert rc == jrc == 0
    assert _strip_record(out.out) == _strip_record(jout.out)
    beats = {}
    for main, name in ((tcli.main, "port"), (jcli, "jax")):
        for d in (td, jd):
            assert main(["report", str(d), "--json"]) == 0
            ov = json.loads(capsys.readouterr().out)["overlap"]
            assert main(["report", str(d)]) == 0
            text = [ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("  overlap: ")]
            beats[(name, d.name)] = (tuple(sorted(ov)), ov["present"], ov["series"] != [],
                                     type(ov["exposed_io_stalled"]), len(text))
    assert len(set(beats.values())) == 1, beats
    assert beats[("port", "port")][1] is True and beats[("port", "port")][4] == 1
    data = treport.report_data(str(td))
    assert 0.0 <= data["overlap"]["efficiency"] <= 1.0


def test_overlap_run_clean_without_checkpointing():
    res = check(tfrl.make_model(2, 2, 2), min_bucket=32, device="cpu")  # the default: on
    assert res.ok and res.stats["overlap"]["enabled"]
    assert "ckpt_worker" not in res.stats["overlap"] and "io_worker" in res.stats["overlap"]
