"""PyTorch port: the device-resident sharded level's checkpoints, faults
and processes against the JAX package's, with zero tolerance (the helpers
and references of tests/test_torch_sharded_device.py): a checkpoint cut
under one pipeline resumed under the other, both ways, and across the two
packages; the elastic 4 -> 2 reshard on the device level; flip@exchange
under the device level; and a two-process gloo group, equal to one
process."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience.integrity import IntegrityError as JIntegrityError
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience.faults import InjectedCrash
from kafka_specification_tpu_torch.resilience.integrity import IntegrityError
from test_torch_sharded_device import (KW, REPO, jax_mesh, jax_thw, jthw, port_run, tthw,
                                       verdict)
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.sharded_device


def test_resume_across_pipelines_and_from_jax(monkeypatch, tmp_path, tmp_path_factory):
    """A checkpoint cut at depth 6 under one pipeline resumes under the
    other, both ways, to JAX's levels, verdict and chain; the port resumes
    JAX's device-level checkpoint, and JAX the port's, to the same."""
    jres, _, jchain = jax_thw("device", tmp_path_factory, monkeypatch)
    kw = dict(mesh=ShardMesh(4, "cpu"), checkpoint_every=1, **KW)
    for first, second in (("device", "legacy"), ("legacy", "device")):
        ck = str(tmp_path / f"ck-{first}")
        cut = check_sharded(tthw(), pipeline=first, checkpoint_dir=ck, max_depth=6, **kw)
        assert cut.diameter == 6
        res, _, chain = port_run(monkeypatch, tmp_path, tthw(), pipeline=second,
                                 checkpoint_dir=ck, **kw)
        assert verdict(res) == verdict(jres) and np.array_equal(chain, jchain)
    jck = str(tmp_path / "jax-ck")
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", "1")
    jcut = jsharded.check_sharded(jthw(), mesh=jax_mesh(4), pipeline="device",
                                  checkpoint_dir=jck, checkpoint_every=1, max_depth=6, **KW)
    assert jcut.diameter == 6
    port_ck = str(tmp_path / "port-ck")
    cut = check_sharded(tthw(), pipeline="device", checkpoint_dir=port_ck, max_depth=6, **kw)
    for k in ("pending", "pending_lens", "levels", "total", "digest_chain", "vn"):
        a = tckpt.verify_file(os.path.join(jck, "sharded_checkpoint.npz"))[k]
        assert np.array_equal(a, tckpt.verify_file(os.path.join(port_ck,
                                                                "sharded_checkpoint.npz"))[k]), k
    res, _, chain = port_run(monkeypatch, tmp_path, tthw(), pipeline="device", checkpoint_dir=jck,
                             **kw)
    assert verdict(res) == verdict(jres) and np.array_equal(chain, jchain)
    assert res.stats["device"]["levels"] == 3  # from depth 6 to the verdict at 8
    back = jsharded.check_sharded(jthw(), mesh=jax_mesh(4), pipeline="device",
                                  checkpoint_dir=port_ck, checkpoint_every=1, **KW)
    assert verdict(back) == verdict(jres)
    assert cut.diameter == 6


def test_elastic_4_to_2_under_the_device_level(monkeypatch, tmp_path):
    """JAX's elastic case: a D = 4 device-level run crashed at level 2
    resumes on D = 2, still on the device level, to the per-chunk path's
    result and chain."""
    kw = dict(min_bucket=8, compact_gate=8)
    golden, _, gchain = port_run(monkeypatch, tmp_path, tfrl.make_model(2, 2, 2),
                                 mesh=ShardMesh(4, "cpu"), pipeline="legacy", **kw)
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("KSPEC_FAULT", "crash@level:2")
    with pytest.raises(InjectedCrash):
        check_sharded(tfrl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), pipeline="device",
                      checkpoint_dir=ck, **kw)
    monkeypatch.delenv("KSPEC_FAULT")
    res, _, chain = port_run(monkeypatch, tmp_path, tfrl.make_model(2, 2, 2),
                             mesh=ShardMesh(2, "cpu"), pipeline="device", checkpoint_dir=ck, **kw)
    assert res.ok and res.total == 49 and verdict(res) == verdict(golden)
    assert np.array_equal(chain, gchain) and res.stats["device"]["levels"] > 0


def test_flip_exchange_under_the_device_level(monkeypatch):
    """flip@exchange:5 corrupts the received framing accumulator of the
    level to depth 5: JAX's IntegrityError, at JAX's depth, message for
    message."""
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", "1")
    monkeypatch.setenv("KSPEC_FAULT", "flip@exchange:5")
    with pytest.raises(IntegrityError) as ei:
        check_sharded(tthw(), mesh=ShardMesh(4, "cpu"), pipeline="device", **KW)
    with pytest.raises(JIntegrityError) as ej:
        jsharded.check_sharded(jthw(), mesh=jax_mesh(4), pipeline="device", **KW)
    assert ei.value.site == ej.value.site == "exchange"
    assert ei.value.depth == ej.value.depth == 4
    assert str(ei.value) == str(ej.value)


_WORKER = """
import json, sys
from kafka_specification_tpu_torch.parallel.multihost import ShardMesh, init_distributed
from kafka_specification_tpu_torch.parallel import check_sharded
from kafka_specification_tpu_torch.models import variants
from kafka_specification_tpu_torch.models.kafka_replication import Config
init_distributed("cpu")
out = {}
for backend in ("device", "host"):
    res = check_sharded(variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1),
                                            ("TypeOk", "WeakIsr")),
                        mesh=ShardMesh(4, "cpu"), pipeline="device", visited_backend=backend,
                        min_bucket=8, compact_gate=8, chunk_size=64)
    out[backend] = {"levels": res.levels, "total": res.total, "device": res.stats["device"],
                    "trace": [[a, repr(s)] for a, s in res.violation.trace]}
print("RESULT " + json.dumps(out), flush=True)
"""


def test_two_gloo_processes_equal_one(monkeypatch):
    """Two processes of a gloo group, two shards each: every process's
    device-level run (device and host) equals the one-process run."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                 RANK=str(rank), PYTHONPATH=REPO, KSPEC_EXCHANGE_COMPRESS="1"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("RESULT ")][-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", "1")
    for backend in ("device", "host"):
        res = check_sharded(tthw(), mesh=ShardMesh(4, "cpu"), pipeline="device",
                            visited_backend=backend, **KW)
        want = {"levels": res.levels, "total": res.total, "device": res.stats["device"],
                "trace": [[a, repr(s)] for a, s in res.violation.trace]}
        assert outs[0][backend] == outs[1][backend] == want
        assert want["device"]["levels"] > 0
