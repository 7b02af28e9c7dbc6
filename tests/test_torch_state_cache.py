"""PyTorch port: the state-space cache (service/state_cache.py) against the
JAX package's, on the CPU: a publish of the same exploration writes the
same KRUN1 visited run, boundary .npy and chain byte for byte, and an
equal entry (its creation time, self-digest and nonce'd names aside); each
package serves a chain-verified hit, and a seed, from the other's
publish; enospc@cache aborts a publish cleanly and flip@cache is caught
at the next lookup, through the port's daemon.  Model:
KafkaTruncateToHighWatermark 2r L2 R1 E1 with TypeOk (353 states)."""

import functools
import json
import os

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.service import state_cache as jsc
from kafka_specification_tpu.utils.cfg import parse_cfg as jparse_cfg
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.interop import to_u32
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.service import queue as tqueue
from kafka_specification_tpu_torch.service import state_cache as tsc
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.utils.cfg import parse_cfg
from kafka_specification_tpu_torch.verdict import verdict_from_result
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.service

THW = "KafkaTruncateToHighWatermark"
CFG = """
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 1
    MaxLeaderEpoch = 1
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    # the fault ordinals count publishes per process: each test counts from 1
    monkeypatch.setitem(tsc._publish_ordinal, "n", 0)


def tmodel():
    return tvariants.make_model(THW, Config(2, 2, 1, 1), ("TypeOk",))


@functools.lru_cache(maxsize=None)
def jmodel():
    return jvariants.make_model(THW, JConfig(2, 2, 1, 1), ("TypeOk",))


def spec(max_depth=None):
    return {"module": THW, "max_depth": max_depth, "max_states": None}


def keys(max_depth=None):
    """The same job's key in each package."""
    return (tsc.key_for_job(spec(max_depth), parse_cfg(CFG), False, ("TypeOk",)),
            jsc.key_for_job(spec(max_depth), jparse_cfg(CFG), False, ("TypeOk",)))


def trim(rows, levels):
    rows = list(rows)
    while len(rows) > len(levels) and not len(rows[-1]):
        rows.pop()
    return rows


@functools.lru_cache(maxsize=None)
def runs(max_depth):
    """Each package's own run of the job: (result, level rows as uint32)."""
    tr, jtr = [], []
    t = check(tmodel(), min_bucket=32, max_depth=max_depth, collect_trace=tr, device="cpu")
    j = jbfs.check(jmodel(), min_bucket=32, max_depth=max_depth, collect_trace=jtr)
    return ((t, trim([to_u32(x[0]) for x in tr], t.levels)),
            (j, trim([np.asarray(x[0], np.uint32) for x in jtr], j.levels)))


def publish_both(tmp_path, max_depth=4):
    (t, trows), (j, jrows) = runs(max_depth)
    tk, jk = keys(max_depth)
    tcache = tsc.StateSpaceCache(str(tmp_path / "t"))
    jcache = jsc.StateSpaceCache(str(tmp_path / "j"))
    m = tmodel()
    assert tcache.publish(tk, verdict_from_result(t), exact64=m.spec.exact64,
                          lanes=m.spec.num_lanes, level_rows=trows, diameter=t.diameter)
    assert jcache.publish(jk, jsc_verdict(j), exact64=m.spec.exact64,
                          lanes=m.spec.num_lanes, level_rows=jrows, diameter=j.diameter)
    return tcache, jcache, tk, jk


def jsc_verdict(res):
    from kafka_specification_tpu.service.verdict import verdict_from_result as jv

    return jv(res)


def entry_dir(cache, key):
    return os.path.join(cache.root, key.base_digest(), key.bounds_name())


def load_entry(cache, key):
    with open(os.path.join(entry_dir(cache, key), "entry.json")) as fh:
        return json.load(fh)


def test_published_files_equal_jax_byte_for_byte(tmp_path):
    tcache, jcache, tk, jk = publish_both(tmp_path)
    assert tk.base_digest() == jk.base_digest() and tk.bounds_name() == jk.bounds_name()
    te, je = load_entry(tcache, tk), load_entry(jcache, jk)
    for side in (te, je):
        assert side["artifact"] is not None and side["bound_limited"]
    for part in ("visited", "boundary"):
        tn, jn = te["artifact"][part]["name"], je["artifact"][part]["name"]
        with open(os.path.join(entry_dir(tcache, tk), tn), "rb") as a, \
                open(os.path.join(entry_dir(jcache, jk), jn), "rb") as b:
            assert a.read() == b.read(), part
    assert te["artifact"]["chain"] == je["artifact"]["chain"]

    def scrub(e):
        e = json.loads(json.dumps(e))
        for k in ("created_unix", "self_digest"):
            e.pop(k)
        for part in ("visited", "boundary"):
            e["artifact"][part].pop("name")
        for k in ("seconds", "states_per_sec"):
            e["verdict"].pop(k)
        return e

    assert scrub(te) == scrub(je)
    assert tsc.entry_self_digest(te) == te["self_digest"]


def test_each_package_serves_a_verified_hit_and_seed_from_the_other(tmp_path):
    tcache, jcache, tk, jk = publish_both(tmp_path)
    cross_t = tsc.StateSpaceCache(jcache.root)  # the port reads JAX's publish
    cross_j = jsc.StateSpaceCache(tcache.root)  # JAX reads the port's
    t_hit, j_hit = cross_t.lookup(tk), cross_j.lookup(jk)
    assert isinstance(t_hit, tsc.CacheHit) and isinstance(j_hit, jsc.CacheHit)
    assert t_hit.verdict["levels"] == j_hit.verdict["levels"] == [1, 4, 14, 30, 42]
    tk_deep, jk_deep = keys(None)
    t_seed, j_seed = cross_t.lookup(tk_deep), cross_j.lookup(jk_deep)
    assert isinstance(t_seed, tsc.CacheSeed) and isinstance(j_seed, jsc.CacheSeed)
    assert t_seed.from_depth == j_seed.from_depth == 4
    cold = check(tmodel(), min_bucket=32, device="cpu")
    seeded = check(tmodel(), min_bucket=32, seed=t_seed.seed, device="cpu")
    j = jbfs.check(jmodel(), min_bucket=32, seed=j_seed.seed)
    assert seeded.levels == cold.levels == j.levels and seeded.total == 353


def test_a_port_daemon_serves_a_hit_from_a_jax_publish(tmp_path):
    _tcache, jcache, _tk, _jk = publish_both(tmp_path)
    q = tqueue.JobQueue(str(tmp_path / "svc"))
    job = q.submit(CFG, THW, max_depth=4)["job_id"]
    d = Daemon(ServeConfig(q.dir, device="cpu", min_bucket=32, linger_s=0.0,
                           state_cache_dir=jcache.root))
    assert d.drain_once() == 1
    rec = q.result(job)
    assert rec["cache"]["state_cache"] == "hit" and d.groups_run == 0
    assert rec["levels"] == [1, 4, 14, 30, 42]


def _events(svc):
    with open(os.path.join(svc, "service", "events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_enospc_at_cache_aborts_the_publish_and_keeps_the_verdict(tmp_path, monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "enospc@cache:1")
    q = tqueue.JobQueue(str(tmp_path / "svc"))
    job = q.submit(CFG, THW, max_depth=4)["job_id"]
    d = Daemon(ServeConfig(q.dir, device="cpu", min_bucket=32, linger_s=0.0))
    assert d.drain_once() == 1
    assert q.result(job)["levels"] == [1, 4, 14, 30, 42]
    fallbacks = [e for e in _events(q.dir) if e.get("event") == "cache-fallback"]
    assert len(fallbacks) == 1 and "publish-error" in fallbacks[0]["reason"]
    tk, _ = keys(4)
    d_entry = entry_dir(d.state_cache, tk)
    assert not os.path.exists(os.path.join(d_entry, "entry.json"))
    assert not [n for n in os.listdir(d_entry) if ".tmp" in n]  # no torn entry left
    # the next job runs cold (a miss) and publishes
    job2 = q.submit(CFG, THW, max_depth=4)["job_id"]
    assert d.drain_once() == 1
    assert q.result(job2).get("cache") is None
    assert os.path.exists(os.path.join(d_entry, "entry.json"))


def test_flip_at_cache_is_caught_at_the_next_lookup(tmp_path, monkeypatch):
    """The daemon's own flip@cache:1 corrupts its first published artifact;
    the deeper job's lookup rejects it (cache-fallback, artifact-corrupt)
    and runs cold to the cold verdict."""
    monkeypatch.setenv("KSPEC_FAULT", "flip@cache:1")
    q = tqueue.JobQueue(str(tmp_path / "svc"))
    first = q.submit(CFG, THW, max_depth=4)["job_id"]
    d = Daemon(ServeConfig(q.dir, device="cpu", min_bucket=32, linger_s=0.0))
    assert d.drain_once() == 1
    deep = q.submit(CFG, THW)["job_id"]
    assert d.drain_once() == 1
    rec = q.result(deep)
    assert rec.get("cache") is None and rec["distinct_states"] == 353
    assert rec["levels"][:5] == q.result(first)["levels"]
    reasons = [e["reason"] for e in _events(q.dir) if e.get("event") == "cache-fallback"]
    assert len(reasons) == 1 and reasons[0].startswith("artifact-corrupt")
