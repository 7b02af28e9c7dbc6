"""PyTorch port: the sharded engine's checkpoints, resumes and faults
(parallel/sharded.py, storage/parent_log.py::ShardedParentLog, the part
files of resilience/checkpoints.py, the shard scopes of
resilience/faults.py), the JAX package's tests/test_sharded_resilience.py
on the port, and the two packages' checkpoints against each other: the
search arrays of a checkpoint equal array for array, each resumed by the
other package on the same mesh and elastically, and the offline
verifier's record equal to JAX's.  The JAX side runs only where the two
packages meet; a port run's golden is the port's own uninterrupted run,
which tests/test_torch_sharded.py holds against JAX's."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.resilience import faults as jfaults
from kafka_specification_tpu.storage import parent_log as jplog
from kafka_specification_tpu_torch import check, cli
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience.faults import FaultPlan, InjectedCrash
from kafka_specification_tpu_torch.resilience.integrity import IntegrityError
from kafka_specification_tpu_torch.storage.parent_log import ShardedParentLog
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = Config(2, 2, 1, 1)
THW = "KafkaTruncateToHighWatermark"
BASE = "sharded_checkpoint.npz"
# the arrays of a checkpoint that depend only on the search (the visited
# sets are compared as sets, `vcap` is the width policy's)
SEARCH = ("pending", "pending_lens", "levels", "total", "mesh_D", "mesh_P", "digest_chain",
          "depth", "ident")


@pytest.fixture(autouse=True)
def _fast_retry(monkeypatch):
    monkeypatch.setenv("KSPEC_RETRY_BASE_DELAY", "0.001")
    monkeypatch.setenv("KSPEC_RETRY_MAX_DELAY", "0.01")


def verdict(res):
    return (res.total, res.diameter, tuple(res.levels), res.ok,
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def mesh(n):
    return ShardMesh(n, "cpu")


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def violating():
    return variants.make_model(THW, TINY, ("TypeOk", "WeakIsr"))


def frl():
    return tfrl.make_model(2, 2, 2)


def crashed(monkeypatch, plan, *args, **kw):
    """check_sharded under `plan`, which must stop it with InjectedCrash."""
    monkeypatch.setenv("KSPEC_FAULT", plan)
    with pytest.raises(InjectedCrash):
        check_sharded(*args, **kw)
    monkeypatch.delenv("KSPEC_FAULT")


def replay_through_oracle(trace):
    """Each step of a reported trace is a transition of the port's oracle."""
    o = variants.make_oracle(THW, TINY, ("TypeOk",))
    actions = {a.name: a for a in o.actions}
    cur = o.init_states()[0]
    assert trace[0] == ("<init>", cur)
    for name, nxt in trace[1:]:
        assert nxt in set(actions[name].successors(cur)), name
        cur = nxt


# --- the shard-scoped fault grammar, against JAX's ---------------------------


def test_shard_scoped_fault_grammar():
    plan = ("crash@shard2:level:5,corrupt_ckpt@shard0,transient_device_err@shard1:3,"
            "crash@shard0:ckpt:4")
    p, j = FaultPlan(plan), jfaults.FaultPlan(plan)
    assert [(s.kind, s.shard, s.budget) for s in p.specs] == [
        (s.kind, s.shard, s.budget) for s in j.specs] == [
        ("crash", 2, 1), ("corrupt_ckpt", 0, 1), ("transient_device_err", 1, 3), ("crash", 0, 1)]
    for bad in ("crash@shard:level:5", "crash@shardX:level:5", "crash@shard1:bogus:5",
                "transient_device_err@shard1:x", "corrupt_ckpt@shard1:3"):
        with pytest.raises(ValueError):
            FaultPlan(bad)


def test_shard_scoped_crash_fires_only_on_owner():
    p = FaultPlan("crash@shard2:level:3")
    p.set_local_shards([0, 1])  # another process owns shard 2
    p.crash("level", 3)
    p.set_local_shards([2, 3])
    with pytest.raises(InjectedCrash):
        p.crash("level", 3)
    p.crash("level", 3)  # its budget spent


def test_shard_scoped_transient_and_corrupt_respect_scope():
    p = FaultPlan("transient_device_err@shard1:2,corrupt_ckpt@shard0")
    p.set_local_shards([0])
    assert p.chunk_error(escalated=False) is None
    assert p.should_corrupt(1) is True
    p2 = FaultPlan("transient_device_err@shard1:2")
    p2.set_local_shards([1])
    assert p2.chunk_error(escalated=False) is not None
    assert p2.chunk_error(escalated=False) is not None
    assert p2.chunk_error(escalated=False) is None
    p3 = FaultPlan("flip@shard3:exchange:2")
    p3.set_local_shards([0, 1])
    assert not p3.flip("exchange", 5)
    p3.set_local_shards([3])
    assert p3.flip("exchange", 5).shard == 3


def test_unscoped_plan_unaffected_by_local_shards():
    p = FaultPlan("crash@level:2")
    p.set_local_shards([3])
    with pytest.raises(InjectedCrash):
        p.crash("level", 2)


def test_out_of_range_shard_scope_fails_loudly(monkeypatch):
    p = FaultPlan("crash@shard5:level:3")
    p.validate_shards(8)
    with pytest.raises(ValueError, match="out of range"):
        p.validate_shards(2)
    monkeypatch.setenv("KSPEC_FAULT", "crash@shard5:level:3")
    with pytest.raises(ValueError, match="out of range"):
        check_sharded(tfrl.make_model(2, 2, 1), mesh=mesh(2), min_bucket=32, store_trace=False)


# --- the per-shard parent log, against JAX's -----------------------------------


def test_sharded_plog_start_fresh_wipes_only_local_shards(tmp_path):
    """A process's start_fresh touches its own shard directories only; the
    epoch writer also clears an abandoned layout's.  The segments and the
    epochs file are JAX's byte for byte."""
    for cls, d in ((ShardedParentLog, tmp_path / "p"), (jplog.ShardedParentLog, tmp_path / "j")):
        d = str(d)
        coord = cls(d, 3, 2, local_shards={0}, epoch_writer=True)
        coord.start_fresh()
        rows = np.arange(3, dtype=np.uint32).reshape(1, 3)
        coord.write_level(0, [rows, rows], [np.array([-1])] * 2, [np.array([-1])] * 2)
        peer = cls(d, 3, 2, local_shards={1}, epoch_writer=False)
        peer.start_fresh()
        assert os.path.exists(os.path.join(d, "epochs.json"))
        assert os.path.exists(os.path.join(d, "shard0", "level-00000.plog"))
        os.makedirs(os.path.join(d, "shard7"))
        cls(d, 3, 2, local_shards={0}, epoch_writer=True).start_fresh()
        assert not os.path.exists(os.path.join(d, "shard7"))
    for rel in ("epochs.json",):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


def test_reshard_rewrites_the_boundary_level_as_jax(tmp_path):
    """reshard() re-emits the boundary level in the new shard-major order,
    each row keeping its (parent, act): the files are JAX's."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**32, size=(7, 3), dtype=np.uint64).astype(np.uint32)
    for cls, d in ((ShardedParentLog, tmp_path / "p"), (jplog.ShardedParentLog, tmp_path / "j")):
        old = cls(str(d), 3, 2)
        old.start_fresh()
        old.write_level(0, [rows[:3], rows[3:]], [np.full(3, -1), np.full(4, -1)],
                        [np.arange(3), np.arange(4)])
        log = cls(str(d), 3, 3)  # the resuming run's layout
        assert log.reshard(0, [rows[[6, 0]], rows[[1, 5]], rows[[2, 3, 4]]])
        assert log.has_levels(0)
        assert np.array_equal(log.view()[0][2], [3, 0, 1, 2, 2, 0, 1])
    for rel in ("epochs.json", "shard0/level-00000.plog", "shard1/level-00000.plog",
                "shard2/level-00000.plog"):
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


# --- the offline verifier, against JAX's -------------------------------------------


def _verify_dirs(tmp_path):
    """The JAX tests' three hand-made sharded directories, written by the
    port's store: stale old-layout parts, a device-hash main with no parts,
    a disk-tier part's spill manifest."""
    from kafka_specification_tpu_torch.storage.runs import _HEADER

    a = tmp_path / "stale"
    st = tckpt.CheckpointStore(str(a), BASE, ident="m|backend=host|inv=-", keep=3)
    for p in (0, 1):
        st.save(3, {"host_fps": np.zeros(2, np.uint64), "mesh_D": 2, "mesh_P": 2},
                part=f"host{p}")
    st.save(3, {"pending": np.zeros((0, 3), np.uint32), "mesh_D": 2, "mesh_P": 2})
    st.save(3, {"pending": np.zeros((0, 3), np.uint32), "host_fps": np.zeros(4, np.uint64),
                "mesh_D": 1, "mesh_P": 1})
    b = tmp_path / "hash"
    tckpt.CheckpointStore(str(b), BASE, ident="M|lanes=3|backend=device-hash|inv=-|",
                          keep=2).save(5, {"hash_hi": np.zeros(4, np.uint32),
                                           "mesh_D": 4, "mesh_P": 4})
    c = tmp_path / "spill"
    st = tckpt.CheckpointStore(str(c), BASE, ident="M|lanes=3|backend=host|inv=-|x|store=disk",
                               keep=2)
    man = [{"mem_budget": 64, "seq": 1, "runs": [{"name": "run-000000.fps", "count": 7,
                                                   "crc32": 0, "lo": 0, "hi": 9}],
            "pending_delete": []}, None]
    for p, m in ((0, man), (1, [None, {"mem_budget": 64, "seq": 0, "runs": [],
                                       "pending_delete": []}])):
        st.save(3, {"spill_manifest": json.dumps(m), "host_hot": np.zeros(0, np.uint64),
                    "host_hot_lens": np.zeros(2, np.int64), "mesh_D": 2, "mesh_P": 2},
                part=f"host{p}")
    st.save(3, {"pending": np.zeros((0, 3), np.uint32), "mesh_D": 2, "mesh_P": 2})
    return a, b, c, _HEADER


def test_verify_checkpoint_sharded_layouts_equal_jax(tmp_path):
    a, b, c, header = _verify_dirs(tmp_path)
    for d in (a, b, c):
        assert tckpt.verify_checkpoint_dir(str(d)) == jckpt.verify_checkpoint_dir(str(d))
    rep = tckpt.verify_checkpoint_dir(str(a))
    gens = rep["stores"][0]["generations"]
    assert rep["ok"] and gens[0]["parts"] == {} and gens[1]["parts"] == {"host0": 0, "host1": 0}
    assert tckpt.verify_checkpoint_dir(str(b))["ok"]
    assert not tckpt.verify_checkpoint_dir(str(c))["ok"]
    spill = c / "spill" / "shard0"
    spill.mkdir(parents=True)
    (spill / "run-000000.fps").write_bytes(b"\0" * (header + 8 * 7))
    rep = tckpt.verify_checkpoint_dir(str(c))
    assert rep == jckpt.verify_checkpoint_dir(str(c)) and rep["ok"]
    assert rep["stores"][0]["generations"][0]["part_spill"]["host0"]["files_checked"] == 1


def test_load_pairs_parts_by_depth_and_layout(tmp_path):
    """load(parts=) -> JAX's 3-tuple; a part pairs with a main by depth and
    mesh stamps, so a torn generation falls back to the newest whole one."""
    st = tckpt.CheckpointStore(str(tmp_path), BASE, ident="x", keep=3)
    for depth in (1, 2):
        st.save(depth, {"h": np.full(2, depth), "mesh_D": 2, "mesh_P": 2}, part="host1")
        st.save(depth, {"m": np.full(3, depth), "mesh_D": 2, "mesh_P": 2})
    st.save(3, {"m": np.full(3, 3), "mesh_D": 2, "mesh_P": 2})  # its part never written
    main, parts, gen = st.load(parts=("host1",))
    assert (int(main["depth"]), gen, int(parts["host1"]["depth"])) == (2, 1, 2)
    jmain, jparts, jgen = jckpt.CheckpointStore(str(tmp_path), BASE, ident="x",
                                                keep=3).load(parts=("host1",))
    assert jgen == gen and set(jparts) == set(parts)
    alias = tckpt.CheckpointStore(str(tmp_path), BASE, ident="y", keep=3, ident_aliases=("x",))
    assert alias.load(parts=lambda m: ())[2] == 0
    with pytest.raises(ValueError, match="different"):
        tckpt.CheckpointStore(str(tmp_path), BASE, ident="y", keep=3).load()


# --- crash, resume and traces ------------------------------------------------------


@pytest.mark.parametrize("shard,level,exchange", [
    (0, 2, "all_to_all"), (1, 4, "all_to_all"), (0, 6, "all_gather"), (1, 3, "all_gather")])
def test_shard_crash_resume_bit_identical(tmp_path, monkeypatch, shard, level, exchange):
    """crash@shard<d>:level:N, then a resume: the counts and every value of
    the trace (from the per-shard parent logs) are the uninterrupted run's."""
    golden = check_sharded(violating(), mesh=mesh(2), min_bucket=32, exchange=exchange)
    assert golden.violation.depth == 8 and len(golden.violation.trace) == 9
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, f"crash@shard{shard}:level:{level}", violating(), mesh=mesh(2),
            min_bucket=32, checkpoint_dir=ck, exchange=exchange)
    resumed = check_sharded(violating(), mesh=mesh(2), min_bucket=32, checkpoint_dir=ck,
                            exchange=exchange)
    assert verdict(resumed) == verdict(golden)
    assert resumed.violation.trace == golden.violation.trace


def test_sharded_resume_trace_from_parent_log(tmp_path, monkeypatch):
    golden = check_sharded(violating(), mesh=mesh(8), min_bucket=32)
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:4", violating(), mesh=mesh(8), min_bucket=32,
            checkpoint_dir=ck)
    resumed = check_sharded(violating(), mesh=mesh(8), min_bucket=32, checkpoint_dir=ck)
    assert verdict(resumed) == verdict(golden)
    assert resumed.violation.trace == golden.violation.trace
    assert resumed.violation.trace[0][0] == "<init>"


def test_sharded_no_trace_run_skips_parent_log(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:3", violating(), mesh=mesh(8), min_bucket=32,
            checkpoint_dir=ck, store_trace=False)
    assert not os.path.isdir(os.path.join(ck, "plog"))
    resumed = check_sharded(violating(), mesh=mesh(8), min_bucket=32, checkpoint_dir=ck,
                            store_trace=False)
    assert resumed.violation is not None and resumed.violation.trace == []


def test_shard_scoped_transient_retried_in_engine(monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "transient_device_err@shard0:1")
    res = check_sharded(frl(), mesh=mesh(8), min_bucket=32, store_trace=False)
    assert res.ok and res.total == 49 and res.stats["transient_retries"] == 1


def test_shard_scoped_corrupt_checkpoint_falls_back(tmp_path, monkeypatch, capsys):
    """corrupt_ckpt@shard1:ckpt:3 corrupts the depth-3 generation as it is
    written (shard 1 is this process's); the resume falls back to depth 2."""
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_FAULT", "corrupt_ckpt@shard1:ckpt:3")
    cut = check_sharded(frl(), mesh=mesh(4), min_bucket=32, checkpoint_dir=ck, max_depth=3)
    monkeypatch.delenv("KSPEC_FAULT")
    res = check_sharded(frl(), mesh=mesh(4), min_bucket=32, checkpoint_dir=ck)
    assert "resuming from generation 1 (level 2)" in capsys.readouterr().err
    assert res.ok and res.total == 49 and res.levels[:4] == cut.levels


def test_flip_at_exchange_is_an_integrity_error(tmp_path, monkeypatch, capsys):
    """flip@exchange corrupts the received framing digest of the first chunk
    of its level: IntegrityError at site exchange; through the CLI, exit 76
    and the record."""
    monkeypatch.setenv("KSPEC_FAULT", "flip@shard1:exchange:3")
    with pytest.raises(IntegrityError, match="exchange payload framing mismatch at level 3"):
        check_sharded(frl(), mesh=mesh(4), min_bucket=32)
    monkeypatch.delenv("KSPEC_FAULT")
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    try:
        rc = cli.main(["check", os.path.join(REPO, "configs", "FiniteReplicatedLog.cfg"),
                       "--sharded", "--cpu", "--json", "--fault", "flip@exchange:2"])
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 76 and rec["exit_code"] == 76
    assert rec["error"].startswith("INTEGRITY_VIOLATION[exchange]")


# --- elastic resume -------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_elastic_resume_4_to_2_exact_counts(tmp_path, monkeypatch, backend):
    golden = verdict(check(frl(), min_bucket=32, store_trace=False, device="cpu"))
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:2", frl(), mesh=mesh(4), min_bucket=32,
            checkpoint_dir=ck, visited_backend=backend)
    resumed = check_sharded(frl(), mesh=mesh(2), min_bucket=32, checkpoint_dir=ck,
                            visited_backend=backend)
    assert verdict(resumed) == golden and resumed.total == 49


def test_elastic_resume_2_to_4_exact_counts(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:2", frl(), mesh=mesh(2), min_bucket=32, checkpoint_dir=ck)
    resumed = check_sharded(frl(), mesh=mesh(4), min_bucket=32, checkpoint_dir=ck)
    assert resumed.ok and resumed.total == 49


def test_elastic_resume_reports_full_trace(tmp_path, monkeypatch):
    """A D=4 checkpoint resumed at D=2: the counts and a full trace (the
    boundary level's segments rewritten into the new shard order), which
    replays through the oracle to the reported state."""
    golden = check_sharded(violating(), mesh=mesh(4), min_bucket=32)
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:4", violating(), mesh=mesh(4), min_bucket=32,
            checkpoint_dir=ck)
    resumed = check_sharded(violating(), mesh=mesh(2), min_bucket=32, checkpoint_dir=ck)
    assert verdict(resumed) == verdict(golden)
    assert len(resumed.violation.trace) == 9
    replay_through_oracle(resumed.violation.trace)
    assert resumed.violation.trace[-1][1] == resumed.violation.state


def test_legacy_layout_baked_ident_still_resumes_same_mesh(tmp_path, monkeypatch):
    """A checkpoint whose ident bakes the layout in (the pre-elastic form,
    no mesh stamps) resumes on that mesh only."""
    ck = str(tmp_path / "ck")
    crashed(monkeypatch, "crash@level:2", frl(), mesh=mesh(8), min_bucket=32,
            checkpoint_dir=ck, store_trace=False)
    path = os.path.join(ck, BASE)
    arrays = tckpt.verify_file(path)
    ident = str(arrays.pop("ident"))
    depth = int(arrays.pop("depth"))
    D, P = int(arrays.pop("mesh_D")), int(arrays.pop("mesh_P"))
    head, _, tail = ident.partition("|backend=")
    for name in os.listdir(ck):
        if name != BASE:
            os.unlink(os.path.join(ck, name))
    tckpt.CheckpointStore(ck, BASE, ident=f"{head}|D={D}|P={P}|backend={tail}",
                          keep=1).save(depth, arrays)
    other = str(tmp_path / "other")
    shutil.copytree(ck, other)
    res = check_sharded(frl(), mesh=mesh(8), min_bucket=32, checkpoint_dir=ck, store_trace=False)
    assert res.ok and res.total == 49
    with pytest.raises(ValueError, match="different"):
        check_sharded(frl(), mesh=mesh(4), min_bucket=32, checkpoint_dir=other)


def test_elastic_resume_still_rejects_other_model(tmp_path):
    ck = str(tmp_path / "ck")
    check_sharded(frl(), mesh=mesh(8), max_depth=1, min_bucket=32, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different"):
        check_sharded(tfrl.make_model(2, 3, 2), mesh=mesh(8), min_bucket=32, checkpoint_dir=ck)


# --- across the packages --------------------------------------------------------------


_JAX_CUT: dict = {}


def jax_cut(backend, tmp_path_factory):
    """JAX's FRL(2,2,2) at D=4 with a checkpoint every level, cut at depth
    3 (once per backend and module): its directory."""
    if backend not in _JAX_CUT:
        d = str(tmp_path_factory.mktemp("jaxcut") / "ck")
        jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(4), min_bucket=32,
                               max_depth=3, checkpoint_dir=d, visited_backend=backend)
        _JAX_CUT[backend] = d
    return _JAX_CUT[backend]


def visited_sets(arrays):
    """A checkpoint's visited set per shard, as sorted uint64 arrays."""
    if "vn" in arrays:
        his = [arrays["vhi"][d, : int(n)] for d, n in enumerate(arrays["vn"])]
        los = [arrays["vlo"][d, : int(n)] for d, n in enumerate(arrays["vn"])]
        lens = list(arrays["vn"])
        hi, lo = np.concatenate(his), np.concatenate(los)
    elif "hash_lens" in arrays:
        hi, lo, lens = arrays["hash_hi"], arrays["hash_lo"], list(arrays["hash_lens"])
    else:
        fps, lens = np.asarray(arrays["host_fps"], np.uint64), list(arrays["host_lens"])
        hi, lo = (fps >> np.uint64(32)).astype(np.uint32), fps.astype(np.uint32)
    fps = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(int)
    return [np.sort(fps[starts[d]:starts[d + 1]]) for d in range(len(lens))]


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_search_arrays_equal_jax(backend, tmp_path, tmp_path_factory):
    """The port's checkpoint at the same cut: the JAX package's files, array
    for array where the array is the search's (the member order too), and
    each shard's visited set equal as a set."""
    jdir = jax_cut(backend, tmp_path_factory)
    ck = str(tmp_path / "ck")
    check_sharded(frl(), mesh=mesh(4), min_bucket=32, max_depth=3, checkpoint_dir=ck,
                  visited_backend=backend)
    for gen in ("", ".1", ".2"):
        name = BASE.replace(".npz", f"{gen}.npz")
        a = tckpt.verify_file(os.path.join(ck, name))
        b = jckpt.verify_file(os.path.join(jdir, name))
        assert list(a) == list(b)
        for k in SEARCH:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (gen, k)
        for x, y in zip(visited_sets(a), visited_sets(b)):
            assert np.array_equal(x, y)
        for k in set(a) - set(SEARCH) - {"vcap"}:
            assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("D", [4, 2])
def test_jax_checkpoint_resumed_by_the_port(D, tmp_path, tmp_path_factory):
    ck = str(tmp_path / "ck")
    shutil.copytree(jax_cut("device", tmp_path_factory), ck)
    res = check_sharded(frl(), mesh=mesh(D), min_bucket=32, checkpoint_dir=ck)
    assert res.ok and res.total == 49
    assert res.levels == check(frl(), device="cpu").levels


def test_port_checkpoint_resumed_by_jax(tmp_path):
    """The port's D=4 cut resumed by the JAX package at D=4 and, from a copy,
    elastically at D=2."""
    ck = str(tmp_path / "ck")
    check_sharded(frl(), mesh=mesh(4), min_bucket=32, max_depth=3, checkpoint_dir=ck,
                  visited_backend="host")
    other = str(tmp_path / "other")
    shutil.copytree(ck, other)
    for d, D in ((ck, 4), (other, 2)):
        res = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(D), min_bucket=32,
                                     checkpoint_dir=d, visited_backend="host")
        assert res.ok and res.total == 49


def test_verify_checkpoint_record_and_text_equal_jax(tmp_path, capsys):
    """`cli verify-checkpoint` of a port-written sharded directory: the
    record and the text (shards x procs, chain) are the JAX CLI's."""
    from kafka_specification_tpu.utils.cli import main as jmain

    ck = str(tmp_path / "ck")
    check_sharded(frl(), mesh=mesh(4), min_bucket=32, max_depth=3, checkpoint_dir=ck)
    for argv in (["verify-checkpoint", ck, "--json"], ["verify-checkpoint", ck]):
        rc = cli.main(argv)
        out = capsys.readouterr().out
        jrc = jmain(argv)
        jout = capsys.readouterr().out
        assert rc == jrc == 0 and out == jout
    assert "shards 4 x procs 1" in out and "chain ok" in out


def test_cli_sharded_json_equals_jax_at_one_shard(tmp_path, capsys, monkeypatch):
    """`check --sharded --json`: the port's record against JAX's CLI run with
    one virtual device (D = 1 on both sides), timing fields aside."""
    cfg = os.path.join(REPO, "configs", "IdSequence.cfg")
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "kafka_specification_tpu.utils.cli", "check", cfg, "--sharded",
         "--cpu", "--hand", "--json"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    rc = cli.main(["check", cfg, "--sharded", "--cpu", "--json"])
    port = capsys.readouterr().out

    def record(text):
        rec = json.loads(text.strip().splitlines()[-1])
        return {k: v for k, v in rec.items() if k not in ("seconds", "states_per_sec", "run_id")}

    assert rc == out.returncode == 0, out.stderr[-2000:]
    assert record(port) == record(out.stdout)
    assert record(port)["distinct_states"] == 12


def test_run_context_shard_heartbeats_gauges_and_report(tmp_path, capsys, monkeypatch):
    """`cli check --sharded --run-dir`: the manifest records sharded, every
    process appends its shard heartbeats to <run>/shards/proc<i>.jsonl (the
    JAX package's records), the per-shard gauges and the launches gauge
    land in metrics.prom, and `cli report` renders the run as JAX's does."""
    from kafka_specification_tpu.utils.cli import main as jmain

    run = tmp_path / "run"
    cfg = os.path.join(REPO, "configs", "FiniteReplicatedLog.cfg")
    assert cli.main(["check", cfg, "--sharded", "--cpu", "--json", "--run-dir", str(run)]) == 0
    capsys.readouterr()
    manifest = json.loads((run / "manifest.json").read_text())
    assert manifest["config"]["sharded"] is True and manifest["config"]["engine"] == "sharded"
    beats = [json.loads(line) for line in (run / "shards" / "proc0.jsonl").read_text().splitlines()]
    assert [b.get("event") for b in (beats[0], beats[-1])] == ["start", "finish"]
    assert [b["depth"] for b in beats[1:-1]] == list(range(1, 14))  # the last level is empty
    assert {(b["kind"], b["proc"], tuple(b["shards"])) for b in beats} == {
        ("shard-heartbeat", 0, (0,))}
    prom = (run / "metrics.prom").read_text()
    for gauge in ("kspec_shard_new", "kspec_shard_imbalance", "kspec_shard_frontier",
                  "kspec_shard_launches_level"):
        assert gauge in prom, gauge
    assert cli.main(["report", str(run)]) == 0
    out = capsys.readouterr().out
    assert jmain(["report", str(run)]) == 0
    assert out == capsys.readouterr().out and "[COMPLETE]" in out


def test_cli_sharded_exit_75_resumes_and_verifies(tmp_path, capsys, monkeypatch):
    """enospc@ckpt:3 under `check --sharded --checkpoint`: exit 75 with the
    RESOURCE_EXHAUSTED record, the directory verifies, and the same command
    resumes it to the end (exit 0)."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    ck = str(tmp_path / "ck")
    argv = ["check", os.path.join(REPO, "configs", "IdSequence.cfg"), "--sharded", "--cpu",
            "--json", "--checkpoint", ck]
    try:
        rc = cli.main(argv + ["--fault", "enospc@ckpt:3"])
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 75 and rec["error"].startswith("RESOURCE_EXHAUSTED[enospc]")
    assert cli.main(["verify-checkpoint", ck]) == 0
    assert "shards 1 x procs 1" in capsys.readouterr().out
    assert cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["distinct_states"] == 12
