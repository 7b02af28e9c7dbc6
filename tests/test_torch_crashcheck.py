"""PyTorch port: the crash-consistency torture harness
(``resilience/crashcheck/``, ``durable_io``'s recorder, the durable-io
lint), ``pytest -m crashcheck``.

The JAX package's tests of it, run on the port's modules, then the
port held against the JAX package:

- per protocol, the ops, the crash states, the non-convergent count and
  the op-log summary (``summarize_ops``, paths root-relative) equal
  JAX's, the op-logs recorded with the same entropy (a seeded
  ``os.urandom`` and a fixed ``time.time``) in the same root;
- a recorded FiniteReplicatedLog check on ``device="cpu"`` with a
  checkpoint every level and the overlap layer off issues JAX's op-log
  (the zip clock fixed, so the npz bytes compare);
- each seeded mutant is found by both packages' durable-io lints, and
  the port's tree shows none.
"""

import json
import os
import time

import numpy as np
import pytest

from kafka_specification_tpu_torch import durable_io as _dio
from kafka_specification_tpu_torch.analysis.durable_lint import lint_durable_io
from kafka_specification_tpu_torch.resilience.crashcheck import (
    CRASHCHECK_SCHEMA,
    SCENARIOS,
    list_scenarios,
    run_crashcheck,
)

pytestmark = pytest.mark.crashcheck


def _age(path, s=3600.0):
    old = time.time() - s
    os.utime(path, (old, old))


# --- the durable-io shim --------------------------------------------------


def test_shim_transparent_when_not_recording(tmp_path):
    assert not _dio.recording()
    p = str(tmp_path / "f.txt")
    _dio.write_text(p, "hello", fsync=True)
    assert open(p).read() == "hello"
    _dio.append_text(p, " world")
    assert open(p).read() == "hello world"
    q = str(tmp_path / "g.txt")
    _dio.replace(p, q)
    assert open(q).read() == "hello world" and not os.path.exists(p)
    _dio.fsync_dir(str(tmp_path))
    _dio.unlink(q)
    assert not os.path.exists(q)


def test_recorder_captures_ops_root_relative(tmp_path):
    rec = _dio.OpRecorder(str(tmp_path))
    prev = _dio.install(rec)
    try:
        _dio.write_text(str(tmp_path / "a"), "x", fsync=True)
        _dio.append_text(str(tmp_path / "a"), "y")
        _dio.replace(str(tmp_path / "a"), str(tmp_path / "b"))
        _dio.fsync_dir(str(tmp_path))
        rec.ack("done", n=1)
        # an op outside the recorder's root is not this scenario's
        _dio.write_text(str(tmp_path.parent / "outside.txt"), "z")
    finally:
        _dio.install(prev)
        (tmp_path.parent / "outside.txt").unlink()
    kinds = [op["op"] for op in rec.ops]
    assert kinds == ["write", "append", "rename", "fsync_dir", "ack"]
    assert rec.ops[0]["path"] == "a" and rec.ops[0]["fsynced"]
    assert rec.ops[2] == {"op": "rename", "src": "a", "dst": "b"}
    assert rec.ops[4]["label"] == "done"


def test_sweep_tmp_grace_window(tmp_path):
    aged = tmp_path / "old.json.tmp"
    fresh = tmp_path / "new.json.ab12.tmp"
    keeper = tmp_path / "real.json"
    for p in (aged, fresh, keeper):
        p.write_text("x")
    _age(str(aged))
    removed = _dio.sweep_tmp(str(tmp_path), min_age_s=60.0)
    assert removed == [str(aged)]
    assert not aged.exists() and fresh.exists() and keeper.exists()


# --- the fs model: crash-state semantics ----------------------------------


def test_unfsynced_rename_may_revert_fsynced_may_not():
    """The exact pre-fix obs/atomicio failure mode: tmp -> final rename
    with no directory fsync may revert (or half-persist); with the dir
    fsync recorded it may not."""
    from kafka_specification_tpu_torch.resilience.crashcheck.fsmodel import (
        _vulnerable,
        replay,
    )

    ops = [
        {"op": "write", "path": "f.tmp", "data": b"payload",
         "fsynced": True},
        {"op": "rename", "src": "f.tmp", "dst": "f"},
        {"op": "fsync_dir", "path": "."},
    ]
    # crash after the rename but before the dir fsync: both degradation
    # modes of the rename are legal
    assert {(1, "skip"), (1, "linger")} <= set(_vulnerable(ops, 2))
    reverted = replay({}, ops, 2, {1: ("skip",)})
    assert "f" not in reverted and reverted["f.tmp"] == b"payload"
    lingering = replay({}, ops, 2, {1: ("linger",)})
    assert lingering["f"] == b"payload" and "f.tmp" in lingering
    # once the dir fsync is in the prefix, the rename is invulnerable
    assert not any(idx == 1 for idx, _mode in _vulnerable(ops, 3))


def test_unfsynced_write_tears_and_append_tail_drops():
    from kafka_specification_tpu_torch.resilience.crashcheck.fsmodel import (
        _vulnerable,
        enumerate_crash_states,
        replay,
    )

    ops = [
        {"op": "write", "path": "w", "data": b"0123456789",
         "fsynced": False},
        {"op": "append", "path": "j", "data": b"rec1\n"},
        {"op": "append", "path": "j", "data": b"rec2\n"},
    ]
    vuln = set(_vulnerable(ops, 3))
    assert (0, "data") in vuln  # unfsynced write may tear
    assert (2, "tail") in vuln  # the LAST append per path may drop
    assert (1, "tail") not in vuln  # ...earlier records are durable
    torn = replay({}, ops, 3, {0: ("data", b"01234")})
    assert torn["w"] == b"01234"
    dropped = replay({}, ops, 3, {2: ("skip",)})
    assert dropped["j"] == b"rec1\n"
    # the enumerator emits these as concrete states (dedup collapses a
    # degraded prefix-3 state into an identical earlier clean state, so
    # search the whole set)
    trees = [s.tree for s in enumerate_crash_states({}, ops)]
    assert any(t.get("w", b"") == b"" for t in trees)  # lost entirely
    assert any(t.get("w") == b"01234" for t in trees)  # torn prefix
    assert any(t.get("j") == b"rec1\n" and "w" in t for t in trees)


# --- the full harness -----------------------------------------------------


def test_every_protocol_converges_on_every_crash_state(tmp_path):
    rec = run_crashcheck(workdir=str(tmp_path / "w"))
    assert rec["schema"] == CRASHCHECK_SCHEMA
    assert rec["ok"] and rec["non_convergent"] == 0, rec["findings"][:3]
    assert rec["states"] >= 200
    assert len(rec["protocols"]) >= 6
    assert rec["seconds"] < 60.0
    assert len(rec["scenarios"]) == len(SCENARIOS)
    for s in rec["scenarios"]:
        assert s["states"] > 0 and s["ops"] > 0


def test_protocol_filter_and_unknown_protocol(tmp_path):
    rec = run_crashcheck(protocols=["trace"],
                         workdir=str(tmp_path / "w"))
    assert rec["protocols"] == ["trace"] and rec["ok"]
    with pytest.raises(ValueError, match="no crashcheck scenario"):
        run_crashcheck(protocols=["nonesuch"])


def test_reverted_dirfsync_fix_is_detected(tmp_path, monkeypatch):
    """Revert the atomicio dir-fsync fix in spirit — make every dir fsync a
    silent no-op (so it neither syncs nor records) — and the harness
    must find non-convergent states: that is the gap it exists to
    catch."""
    from kafka_specification_tpu_torch.storage import atomic as atomic_mod

    noop = lambda path: None  # noqa: E731
    monkeypatch.setattr(_dio, "fsync_dir", noop)
    monkeypatch.setattr(atomic_mod, "fsync_dir", noop)
    rec = run_crashcheck(protocols=["queue"],
                         workdir=str(tmp_path / "w"))
    assert not rec["ok"] and rec["non_convergent"] > 0
    f = rec["findings"][0]
    # findings are machine-readable repros
    assert f["scenario"] == "queue-lifecycle"
    assert isinstance(f["prefix"], int) and f["op_log"]
    assert f["state_digest"] and "tree" in f
    json.dumps(rec)  # the whole record is JSON-safe


def test_cli_crashcheck_json_contract(tmp_path, capsys, monkeypatch):
    from kafka_specification_tpu_torch.cli import main as cli_main

    assert cli_main(["crashcheck", "--protocol", "trace",
                     "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["schema"] == CRASHCHECK_SCHEMA and rec["ok"]
    assert cli_main(["crashcheck", "--protocol", "nonesuch"]) == 2


def test_faults_list_carries_scenario_registry(capsys):
    from kafka_specification_tpu_torch.cli import main as cli_main

    assert cli_main(["faults", "--json"]) == 0
    entries = json.loads(capsys.readouterr().out)
    rows = [e for e in entries if e["kind"] == "crashcheck-scenario"]
    assert {r["sites"][0] for r in rows} == {s.name for s in SCENARIOS}
    assert cli_main(["faults"]) == 0
    out = capsys.readouterr().out
    assert "Crashcheck scenarios" in out and "queue-lifecycle" in out
    assert {s["name"] for s in list_scenarios()} == \
        {s.name for s in SCENARIOS}


# --- the durable-write discipline lint ------------------------------------


def test_lint_pins_zero_findings_on_the_real_tree():
    assert lint_durable_io() == []


def test_lint_detects_seeded_mutants(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "import os\n"
        "def f(a, b):\n"
        "    os.replace(a, b)\n"
        "def g(p):\n"
        '    with open(p, "a") as fh:\n'
        '        fh.write("x")\n'
        "def h(a, b):\n"
        "    # kspec: allow(durable-io)\n"
        "    os.rename(a, b)\n"
        "def i(a, b):\n"
        "    # kspec: allow(durable-io) scratch swap, not durable\n"
        "    os.rename(a, b)\n"
        'DOC = """example: os.replace(a, b)"""\n'
    )
    problems = {p["line"]: p["problem"] for p in lint_durable_io(str(pkg))}
    assert "raw os.rename/os.replace" in problems[3]
    assert "append-mode writer" in problems[5]
    assert "carries no reason" in problems[9]
    assert set(problems) == {3, 5, 9}  # reasoned allow + docstring pass


def test_analyze_cli_runs_durable_lint(capsys):
    from kafka_specification_tpu_torch.cli import main as cli_main

    assert cli_main(["analyze", "--no-models", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["ok"]
    assert any("durable-write discipline" in t for t in rec["targets"])


# --- startup-janitor parity: every durable dir collects its orphans -------


def test_queue_open_collects_aged_tmp_orphans(tmp_path):
    from kafka_specification_tpu_torch.service.queue import JobQueue

    q = JobQueue(str(tmp_path / "svc"))
    planted, fresh = [], []
    for d in (os.path.join(q.queue_dir, "pending"),
              os.path.join(q.queue_dir, "claimed"),
              os.path.join(q.queue_dir, "done"),
              q.results_dir):
        p = os.path.join(d, "orphan.json.tmp")
        open(p, "w").write("{")
        _age(p)
        planted.append(p)
        f = os.path.join(d, "inflight.json.ab.tmp")
        open(f, "w").write("{")
        fresh.append(f)
    JobQueue(str(tmp_path / "svc"))
    assert not any(os.path.exists(p) for p in planted)
    # a live sibling's in-flight tmp is inside the grace window: kept
    assert all(os.path.exists(f) for f in fresh)


def test_router_open_collects_aged_route_tmps(tmp_path):
    from kafka_specification_tpu_torch.service.queue import JobQueue
    from kafka_specification_tpu_torch.service.router import Router

    h0 = str(tmp_path / "h0")
    JobQueue(h0)
    r = Router(str(tmp_path / "rt"), hosts=[h0])
    p = os.path.join(r.routes_dir, "j1.json.dead.tmp")
    open(p, "w").write("{")
    _age(p)
    Router(str(tmp_path / "rt"))
    assert not os.path.exists(p)


def test_cache_gc_collects_entryless_orphans(tmp_path):
    """A publisher that dies before its first entry-promote must not
    orphan its artifacts forever — the crashcheck cache scenario found
    collect_garbage refusing to touch an entry-less dir."""
    from kafka_specification_tpu_torch.service.state_cache import (
        CacheKey,
        StateSpaceCache,
    )

    c = StateSpaceCache(str(tmp_path / "sc"))
    key = CacheKey("IdSequence", False, (("MaxId", 3),), ("TypeOk",), (),
                   False, max_depth=2)
    d = c._entry_dir(key)
    os.makedirs(d, exist_ok=True)
    planted = []
    for name in ("visited-dead.run", "visited-dead.run.bloom",
                 "rows-dead.npy", "entry.json.ab12.tmp"):
        p = os.path.join(d, name)
        open(p, "wb").write(b"\xff" * 16)
        _age(p)
        planted.append(p)
    removed = c.collect_garbage(key, grace_s=60.0)
    assert sorted(os.path.basename(p) for p in removed) == sorted(
        os.path.basename(p) for p in planted
    )
    assert not any(os.path.exists(p) for p in planted)


def test_cache_gc_grace_protects_inflight_publisher(tmp_path):
    from kafka_specification_tpu_torch.service.state_cache import (
        CacheKey,
        StateSpaceCache,
    )

    c = StateSpaceCache(str(tmp_path / "sc"))
    key = CacheKey("IdSequence", False, (("MaxId", 3),), ("TypeOk",), (),
                   False, max_depth=2)
    d = c._entry_dir(key)
    os.makedirs(d, exist_ok=True)
    live = os.path.join(d, "visited-live.run")
    open(live, "wb").write(b"\x00" * 16)  # fresh: publisher mid-flight
    assert c.collect_garbage(key, grace_s=60.0) == []
    assert os.path.exists(live)


def test_sweep_manifest_open_collects_aged_tmps(tmp_path):
    from kafka_specification_tpu_torch.sweep.lattice import (
        Axis,
        LatticeSheet,
        LatticeSpec,
    )
    from kafka_specification_tpu_torch.sweep.portfolio import Manifest

    spec = LatticeSpec(name="jan", sheets=[LatticeSheet(
        module="IdSequence", cfg_text="CONSTANTS MaxId = 3",
        axes=[Axis("MaxId", (2, 3))],
    )])
    d = str(tmp_path / "sweep")
    m = Manifest.open_or_create(d, spec)
    m.promote()
    stray = os.path.join(d, "manifest.json.dead.tmp")
    open(stray, "w").write("{torn")
    _age(stray)
    m2 = Manifest.open_or_create(d, spec)
    assert not os.path.exists(stray)
    assert m2.rec["sweep_id"] == m.rec["sweep_id"]


def test_trace_dir_is_append_only_no_tmp_writer(tmp_path):
    # parity note: the traces dir needs no tmp janitor BECAUSE its only
    # writers are O_APPEND emitters — pin that no emit ever creates a
    # tmp file (if one ever does, it must also gain a janitor)
    from kafka_specification_tpu_torch.obs import fleettrace

    trace = fleettrace.mint_trace("job-t", time.time())
    t0 = fleettrace.now()
    fleettrace.emit_span(str(tmp_path), trace, "job-submit", t0,
                         fleettrace.now(), job_id="job-t",
                         span_id=trace["span_id"])
    names = []
    for cur, _d, fns in os.walk(tmp_path):
        names.extend(fns)
    assert names and not any(
        n.endswith(".tmp") or ".tmp." in n for n in names
    )


# --- torn-tail recovery: every O_APPEND journal reader --------------------


def _torn_append(path, lines, torn=b'{"kind": "daemon", "un'):
    with open(path, "ab") as fh:
        for ln in lines:
            fh.write(ln)
        fh.write(torn)  # killed mid-append: no trailing newline


def test_heartbeat_reader_survives_torn_tail(tmp_path):
    from kafka_specification_tpu_torch.obs.tracer import read_jsonl_tolerant
    from kafka_specification_tpu_torch.resilience.heartbeat import append_jsonl

    p = str(tmp_path / "heartbeat.jsonl")
    append_jsonl(p, {"kind": "daemon", "unix": 1.0})
    append_jsonl(p, {"kind": "daemon", "unix": 2.0})
    with open(p, "ab") as fh:
        fh.write(b'{"kind": "daemon", "unix": 3')
    recs = read_jsonl_tolerant(p)
    assert [r["unix"] for r in recs] == [1.0, 2.0]


def test_router_liveness_survives_torn_heartbeat_tail(tmp_path):
    from kafka_specification_tpu_torch.service.queue import JobQueue
    from kafka_specification_tpu_torch.service.router import Router

    h0 = str(tmp_path / "h0")
    JobQueue(h0)
    hb = os.path.join(h0, "service", "heartbeat-daemon.jsonl")
    os.makedirs(os.path.dirname(hb), exist_ok=True)
    stamp = round(time.time(), 3)
    _torn_append(hb, [
        json.dumps({"kind": "daemon", "unix": stamp}).encode() + b"\n",
    ])
    r = Router(str(tmp_path / "rt"), hosts=[h0])
    assert r._newest_heartbeat_unix(0) == stamp


def test_router_event_log_survives_torn_tail(tmp_path):
    from kafka_specification_tpu_torch.obs.tracer import read_jsonl_tolerant
    from kafka_specification_tpu_torch.service.queue import JobQueue
    from kafka_specification_tpu_torch.service.router import Router

    h0 = str(tmp_path / "h0")
    JobQueue(h0)
    r = Router(str(tmp_path / "rt"), hosts=[h0])
    r._event("route", job_id="j1", host=0)
    r._event("route", job_id="j2", host=0)
    with open(r.events_path, "ab") as fh:
        fh.write(b'{"kind": "router", "event": "rou')
    recs = read_jsonl_tolerant(r.events_path)
    assert [x["job_id"] for x in recs] == ["j1", "j2"]


def test_sweep_manifest_resume_with_torn_tmp_stray(tmp_path):
    from kafka_specification_tpu_torch.sweep.lattice import (
        Axis,
        LatticeSheet,
        LatticeSpec,
    )
    from kafka_specification_tpu_torch.sweep.portfolio import (
        Manifest,
        load_manifest,
    )

    spec = LatticeSpec(name="torn", sheets=[LatticeSheet(
        module="IdSequence", cfg_text="CONSTANTS MaxId = 3",
        axes=[Axis("MaxId", (2, 3))],
    )])
    d = str(tmp_path / "sweep")
    m = Manifest.open_or_create(d, spec)
    m.promote()
    # a crashed sibling's half-written promote tmp must never shadow
    # the intact manifest nor break the resume
    stray = os.path.join(d, "manifest.json.beef.tmp")
    open(stray, "wb").write(b'{"sweep_id": "WRONG", "poi')
    _age(stray)
    rec = load_manifest(d)
    assert rec["sweep_id"] == m.rec["sweep_id"]
    m2 = Manifest.open_or_create(d, spec)
    assert m2.rec["sweep_id"] == m.rec["sweep_id"]
    assert not os.path.exists(stray)


def test_readback_chain_tolerates_rotation_window(tmp_path):
    """The post-save chain readback races the NEXT save's keep-K
    rotation: generation 0 is briefly renamed to `.1` before its
    replacement promotes, so the just-verified path can legally be
    absent.  A vanished path means a newer generation superseded this
    one (whose own readback verifies it) — never an error."""
    from kafka_specification_tpu_torch.resilience.integrity import (
        readback_chain,
    )

    readback_chain(str(tmp_path / "gone.npz"), depth=3)  # must not raise


# --- the port against the JAX package -------------------------------------

from kafka_specification_tpu import durable_io as jdio  # noqa: E402
from kafka_specification_tpu.analysis.durable_lint import lint_durable_io as jlint  # noqa: E402
from kafka_specification_tpu.resilience.crashcheck import SCENARIOS as JSCENARIOS  # noqa: E402
from kafka_specification_tpu.resilience.crashcheck import run_crashcheck as jrun  # noqa: E402
from kafka_specification_tpu_torch.resilience.crashcheck.fsmodel import (  # noqa: E402
    summarize_ops,
)
from torch_guards import overlap_guard  # noqa: E402,F401  (autouse)

# the scenarios' modules, imported up front: some draw os.urandom at
# import (the queue's process token), which would shift the seeded draws
# of whichever package imports them first under the patch
import kafka_specification_tpu.resilience.checkpoints  # noqa: E402,F401
import kafka_specification_tpu.service.router  # noqa: E402,F401
import kafka_specification_tpu.service.state_cache  # noqa: E402,F401
import kafka_specification_tpu.storage.runs  # noqa: E402,F401
import kafka_specification_tpu.sweep.portfolio  # noqa: E402,F401
import kafka_specification_tpu_torch.resilience.checkpoints  # noqa: E402,F401
import kafka_specification_tpu_torch.service.router  # noqa: E402,F401
import kafka_specification_tpu_torch.service.state_cache  # noqa: E402,F401
import kafka_specification_tpu_torch.storage.runs  # noqa: E402,F401
import kafka_specification_tpu_torch.sweep.portfolio  # noqa: E402,F401

#: per protocol: (ops, crash states) of JAX's run at the port's parent
#: commit, which the live comparison below holds too
EXPECTED = {"queue": (15, 69), "router": (16, 49), "cache": (20, 37), "ckpt": (7, 32),
            "spill": (24, 40), "sweep": (8, 13), "trace": (7, 14)}


def _sections(rec):
    return {s["protocol"]: (s["name"], s["ops"], s["states"], s["non_convergent"])
            for s in rec["scenarios"]}


def test_every_protocol_equals_jax(tmp_path):
    """Ops, crash states and non-convergent counts per protocol, and the
    totals, equal JAX's live run: 254 states, none non-convergent."""
    rec = run_crashcheck(workdir=str(tmp_path / "p"))
    jrec = jrun(workdir=str(tmp_path / "j"))
    assert _sections(rec) == _sections(jrec)
    assert {p: s[1:3] for p, s in _sections(rec).items()} == EXPECTED
    assert (rec["states"], rec["non_convergent"], rec["ok"]) == (254, 0, True)
    assert (jrec["states"], jrec["non_convergent"]) == (254, 0)
    assert [s["name"] for s in rec["scenarios"]] == [s.name for s in JSCENARIOS]
    assert list_scenarios() == [
        {"name": s.name, "protocol": s.protocol, "description": s.description}
        for s in JSCENARIOS]


def _recorded(scn, dio, queue_mod, root, monkeypatch):
    """One scenario's recorded op-log under fixed entropy: a seeded
    ``os.urandom`` (job ids, nonces, trace ids), a fixed ``time.time``
    (stamps) and one claim token for both packages' queues (each drew
    its own at import), so that two packages' runs in the same root
    compare byte for byte."""
    import random
    import shutil

    rng = random.Random(0)
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", lambda n: rng.randbytes(n))
        m.setattr(time, "time", lambda: 1.7e9)
        m.setattr(queue_mod, "_PROC_TOKEN", "0123456789abcdef")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        scn.setup(root)
        rec = dio.OpRecorder(root)
        prev = dio.install(rec)
        try:
            scn.run(root, rec)
        finally:
            dio.install(prev)
    return summarize_ops(rec.ops)


@pytest.mark.parametrize("index", range(len(SCENARIOS)),
                         ids=[s.protocol for s in SCENARIOS])
def test_op_log_equals_jax(index, tmp_path, monkeypatch):
    root = str(tmp_path / "root")
    ops = _recorded(SCENARIOS[index], _dio, kafka_specification_tpu_torch.service.queue,
                    root, monkeypatch)
    jops = _recorded(JSCENARIOS[index], jdio, kafka_specification_tpu.service.queue,
                     root, monkeypatch)
    assert ops == jops
    assert len(ops) == EXPECTED[SCENARIOS[index].protocol][0]
    assert all(not str(op.get(k, "")).startswith("/") for op in ops
               for k in ("path", "src", "dst"))


def test_recorded_checkpointed_check_equals_jax(tmp_path, monkeypatch):
    """The recorder's call sites in the checkpoint store: a recorded
    FiniteReplicatedLog 3r L3 R2 check with a checkpoint every level and
    the overlap layer off (its saves then run on the calling thread, in
    one order) issues JAX's op-log, write for write; the zip clock is
    fixed so that the npz bytes compare."""
    import types
    import zipfile

    from kafka_specification_tpu.engine import bfs as jbfs
    from kafka_specification_tpu.models import finite_replicated_log as jfrl
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl

    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))
    kw = dict(min_bucket=32, chunk_size=256, compact_gate=32, overlap=False)
    logs = {}
    for name, dio, run in (
        ("port", _dio, lambda d: check(tfrl.make_model(3, 3, 2), device="cpu",
                                       checkpoint_dir=d, **kw)),
        ("jax", jdio, lambda d: jbfs.check(jfrl.make_model(3, 3, 2), checkpoint_dir=d, **kw)),
    ):
        d = str(tmp_path / name)
        rec = dio.OpRecorder(d)
        prev = dio.install(rec)
        try:
            res = run(d)
        finally:
            dio.install(prev)
        logs[name] = (res.levels, summarize_ops(rec.ops))
    assert logs["port"] == logs["jax"]
    levels, ops = logs["port"]
    writes = [op for op in ops if op["op"] == "write"]
    assert len(writes) == len(levels) and all(
        w["path"] == "bfs_checkpoint.npz.tmp.npz" and w["fsynced"] is False for w in writes)


def test_atomic_helpers_and_trace_append_are_recorded(tmp_path):
    """The three other call sites: obs/atomicio (fsync as asked),
    storage/atomic (always fsynced) and the fleet-trace append."""
    from kafka_specification_tpu_torch.obs import atomicio, fleettrace
    from kafka_specification_tpu_torch.storage import atomic

    rec = _dio.OpRecorder(str(tmp_path))
    prev = _dio.install(rec)
    try:
        atomicio.atomic_write_text(str(tmp_path / "m.json"), "{}", fsync=False)
        atomic.atomic_write(str(tmp_path / "r.bin"), lambda fh: fh.write(b"xy"))
        trace = fleettrace.mint_trace("job-r", 1.0)
        fleettrace.emit_event(str(tmp_path), trace, "queue-requeue", job_id="job-r",
                              from_pid=1, by_pid=2, reason="test")
    finally:
        _dio.install(prev)
    ops = [(op["op"], op.get("path", op.get("dst")), op.get("fsynced")) for op in rec.ops]
    assert ops[:5] == [("write", "m.json.tmp", False), ("rename", "m.json", None),
                       ("write", "r.bin.tmp", True), ("rename", "r.bin", None),
                       ("fsync_dir", ".", None)]
    assert ops[5][0] == "append" and ops[5][1].endswith("job-r.jsonl")
    assert rec.ops[5]["data"].startswith(b"\n{")


def test_recorder_takes_ops_from_worker_threads(tmp_path):
    import threading

    rec = _dio.OpRecorder(str(tmp_path))
    prev = _dio.install(rec)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            _dio.append_text(str(tmp_path / f"t{i}"), "x") for _ in range(50)])
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _dio.install(prev)
    assert sorted(op["path"] for op in rec.ops) == sorted(
        f"t{i}" for i in range(4) for _ in range(50))


def test_lints_of_both_packages_find_the_seeded_mutants(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "import os\n"
        "def f(a, b):\n"
        "    os.rename(a, b)\n"
        "def g(p):\n"
        "    fd = os.open(p, os.O_WRONLY | os.O_APPEND)\n"
        "def h(a, b):\n"
        "    os.replace(a, b)  # kspec: allow(durable-io)\n"
    )
    found = lint_durable_io(str(pkg))
    assert found == jlint(str(pkg))
    assert sorted(f["line"] for f in found) == [3, 5, 7]
    assert lint_durable_io() == []
