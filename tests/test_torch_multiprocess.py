"""PyTorch port: the sharded engine across processes (parallel/multihost.py
on torch.distributed, gloo on the CPU).  N processes join one group on
localhost (torchrun's variables: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK), each owning a contiguous block of the mesh's shards; every process
runs the replicated host loop and must reach the JAX package's result at
the same shard count in one process.

Fast: two processes x two shards (D = 4), FRL(2,2,2) on the `host`
backend (one native set a shard, on its owner only; the novelty masks
OR-merged across the group), with a checkpoint every level cut at depth 3:
the levels, the per-shard set sizes, the main file's search arrays and
each process's part file (its shards' fingerprints) against JAX's D = 4
checkpoint, then the cut resumed in one process (elastic, 2 -> 1
processes) by the port and by the JAX package.  Slow, as JAX's own
tests/test_multiprocess.py: four processes x one shard, and a
four-process checkpoint resumed by two."""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = "sharded_checkpoint.npz"

_WORKER = """
import json, sys
from kafka_specification_tpu_torch.parallel.multihost import ShardMesh, init_distributed
from kafka_specification_tpu_torch.parallel import check_sharded
from kafka_specification_tpu_torch.models import finite_replicated_log as frl
cfg = json.loads(sys.argv[1])
info = init_distributed("cpu")
res = check_sharded(frl.make_model(*cfg["model"]), mesh=ShardMesh(cfg["D"], "cpu"),
                    min_bucket=32, store_trace=False, visited_backend=cfg["backend"],
                    max_depth=cfg.get("max_depth"), checkpoint_dir=cfg.get("ckpt"))
print("RESULT " + json.dumps({
    "pid": info["process_id"], "procs": info["process_count"], "total": res.total,
    "levels": res.levels, "ok": res.ok, "host_sizes": res.stats.get("host_fpset_sizes"),
}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_procs(cfg: dict, n_procs: int) -> list:
    """`n_procs` processes of one gloo group, each running _WORKER: their
    RESULT records, in rank order."""
    port = _free_port()
    procs = []
    for rank in range(n_procs):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n_procs), RANK=str(rank), PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, json.dumps(cfg)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, f"no RESULT line:\n{out[-1000:]}\n{err[-2000:]}"
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("d",))


def shard_fps(fps, lens):
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(int)
    return [np.sort(np.asarray(fps, np.uint64)[starts[d]:starts[d + 1]])
            for d in range(len(lens))]


def test_two_processes_host_parts_and_resume_equal_jax(tmp_path):
    ck = str(tmp_path / "ck")
    outs = run_procs({"model": [2, 2, 2], "D": 4, "backend": "host", "max_depth": 3,
                      "ckpt": ck}, 2)
    jck = str(tmp_path / "jax")
    jres = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(4), min_bucket=32,
                                  store_trace=False, visited_backend="host", max_depth=3,
                                  checkpoint_dir=jck)
    assert [o["pid"] for o in outs] == [0, 1] and all(o["procs"] == 2 for o in outs)
    for o in outs:
        assert o["levels"] == jres.levels and o["total"] == jres.total
    # each process holds the sets of its own two shards only
    jsizes = jres.stats["host_fpset_sizes"]
    assert outs[0]["host_sizes"] == jsizes[:2] + [None, None]
    assert outs[1]["host_sizes"] == [None, None] + jsizes[2:]
    main = tckpt.verify_file(os.path.join(ck, BASE))
    jmain = jckpt.verify_file(os.path.join(jck, BASE))
    assert (int(main["mesh_D"]), int(main["mesh_P"])) == (4, 2)
    for k in ("pending", "pending_lens", "levels", "total", "digest_chain", "depth"):
        assert np.array_equal(main[k], jmain[k]), k
    assert "host_fps" not in main  # the sets live in the parts
    want = shard_fps(jmain["host_fps"], jmain["host_lens"])
    for p, owned in ((0, (0, 1)), (1, (2, 3))):
        part = tckpt.verify_file(os.path.join(ck, f"{BASE}.host{p}"))
        assert (int(part["depth"]), int(part["mesh_D"]), int(part["mesh_P"])) == (3, 4, 2)
        got = shard_fps(part["host_fps"], part["host_lens"])
        for d in range(4):
            assert np.array_equal(got[d], want[d] if d in owned else np.empty(0, np.uint64))
    rep = tckpt.verify_checkpoint_dir(ck)
    assert rep == jckpt.verify_checkpoint_dir(ck) and rep["ok"]
    assert rep["stores"][0]["generations"][0]["parts"] == {"host0": 0, "host1": 0}
    # the two-process cut resumed in one process: elastic in the process count
    other = str(tmp_path / "other")
    shutil.copytree(ck, other)
    full = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(4), min_bucket=32,
                                  store_trace=False, visited_backend="host")
    res = check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32,
                        store_trace=False, visited_backend="host", checkpoint_dir=ck)
    assert (res.levels, res.total) == (full.levels, 49)
    jres = jsharded.check_sharded(jfrl.make_model(2, 2, 2), mesh=jax_mesh(4), min_bucket=32,
                                  store_trace=False, visited_backend="host",
                                  checkpoint_dir=other)
    assert (jres.levels, jres.total) == (full.levels, 49)


@pytest.mark.slow
def test_four_processes_one_shard_each():
    outs = run_procs({"model": [3, 4, 1], "D": 4, "backend": "device"}, 4)
    jres = jsharded.check_sharded(jfrl.make_model(3, 4, 1), mesh=jax_mesh(4), min_bucket=32,
                                  store_trace=False)
    for o in outs:
        assert o["ok"] and (o["total"], o["levels"]) == (125, jres.levels)


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["device", "host"])
def test_four_to_two_process_elastic_resume(tmp_path, backend):
    ck = str(tmp_path / "ck")
    cut = run_procs({"model": [3, 4, 1], "D": 4, "backend": backend, "max_depth": 5,
                     "ckpt": ck}, 4)
    assert all(o["total"] < 125 for o in cut)
    outs = run_procs({"model": [3, 4, 1], "D": 2, "backend": backend, "ckpt": ck}, 2)
    for o in outs:
        assert o["ok"] and o["total"] == 125
