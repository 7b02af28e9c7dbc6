"""PyTorch port: check(device="cpu") against the JAX engine's check() over
the knobs that decide the candidate order: visited backend {device,
device-hash, host} x pipeline {legacy, fused} x compact_shift {0, 2}, with the
JAX package's own test knobs (min_bucket 32, chunk_size 256, compact_gate
32, tests/test_pipeline.py), on a violating model (TruncateToHW 2r, WeakIsr)
and a passing one (Kip320 2r L2 R1 E1); then at full defaults, and where
the JAX legacy run overflows its compact buffers and escalates.  Zero
tolerance: every level's rows in order, total, diameter, the first
violation (invariant, depth, state) and the trace, action by action and
state by state."""

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu_torch import check, interop
from kafka_specification_tpu_torch.engine import pipeline as tpipeline
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.pipeline_registry import resolve_pipeline
from torch_guards import overlap_guard  # noqa: F401  (autouse)

KW = dict(min_bucket=32, chunk_size=256, compact_gate=32)
THW = "KafkaTruncateToHighWatermark"
CONSTS = (2, 2, 1, 1)

_MODELS: dict = {}


def models(name):
    """One (JAX, port) model pair per module: the JAX package caches its
    compiled steps on the Model, so sharing it keeps this file's compiles
    to one set per (backend, pipeline, shift)."""
    if name not in _MODELS:
        jc, tc = jkr.Config(*CONSTS), tkr.Config(*CONSTS)
        if name == "Kip320":
            _MODELS[name] = (jkip320.make_model(jc), tkip320.make_model(tc))
        else:
            invs = ("TypeOk", "WeakIsr")
            _MODELS[name] = (jvariants.make_model(name, jc, invs),
                             tvariants.make_model(name, tc, invs))
    return _MODELS[name]


def run_both(name, **kw):
    jmodel, tmodel = models(name)
    jl, tl = [], []
    jr = jbfs.check(jmodel, collect_levels=jl, **kw)
    tr = check(tmodel, device="cpu", collect_levels=tl, **kw)
    assert tr.levels == jr.levels
    assert (tr.total, tr.diameter) == (jr.total, jr.diameter)
    assert len(tl) == len(jl)
    for d, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(interop.to_u32(t), np.asarray(j), err_msg=f"level {d}")
    assert (tr.violation is None) == (jr.violation is None)
    if jr.violation is not None:
        tv, jv = tr.violation, jr.violation
        assert (tv.invariant, tv.depth, tv.state) == (jv.invariant, jv.depth, jv.state)
        assert tv.trace == jv.trace
    assert tr.stats["pipeline"] == jr.stats["pipeline"]
    assert tr.stats["visited_backend"] == jr.stats["visited_backend"]
    return jr, tr


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("pipeline", ["legacy", "fused"])
@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
@pytest.mark.parametrize("name", [THW, "Kip320"])
def test_port_equals_jax_over_the_knobs(name, backend, pipeline, shift):
    jr, tr = run_both(name, visited_backend=backend, pipeline=pipeline,
                      compact_shift=shift, **KW)
    if name == THW:
        assert (tr.violation.invariant, tr.violation.depth) == ("WeakIsr", 8)
    else:
        assert tr.ok and tr.total == 277
    assert tr.stats["visited_capacity"] == jr.stats["visited_capacity"]
    assert tr.stats.get("host_fpset_size") == jr.stats.get("host_fpset_size")


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_full_defaults(backend):
    """No knob but the backend: fused, compact_shift 2, gate 4096, so every
    bucket of this model lies below the gate (state-major order).  The
    sorted set commits a chunk's new states in fingerprint order, the hash
    table in candidate order: the same counts, other level rows, and here
    other traces, each the JAX package's."""
    _, tr = run_both(THW, visited_backend=backend)
    assert tr.stats["pipeline"] == "fused"
    assert not tpipeline.compacts(256, 2, 4096)
    steps = [a for a, _ in tr.violation.trace]
    # the host set commits in candidate order, as the hash table does
    assert steps[3] == ("BecomeFollowerTruncateToHighWatermark" if backend == "device"
                        else "BecomeLeader")


def test_jax_legacy_escalation():
    """compact_shift 5 leaves one row per choice at bucket 32: the JAX
    legacy step overflows its buffers and re-runs chunks at measured
    widths, and its order stays action-major, as the port's."""
    jr, _ = run_both(THW, visited_backend="device", pipeline="legacy",
                     compact_shift=5, **KW)
    assert jr.stats["adaptive_active"]


def test_compact_gate_rule():
    """Action-major order exactly where the JAX legacy path compacts:
    shift > 0, bucket >= gate and bucket >> shift >= 1."""
    assert tpipeline.compacts(32, 2, 32)
    assert not tpipeline.compacts(32, 0, 32)
    assert not tpipeline.compacts(16, 2, 32)
    assert not tpipeline.compacts(32, 6, 32)
    assert tpipeline.compacts(32, 5, 32)


def test_pipeline_names(monkeypatch):
    monkeypatch.delenv("KSPEC_PIPELINE", raising=False)
    assert resolve_pipeline() == "fused"
    assert resolve_pipeline("legacy") == "legacy"
    monkeypatch.setenv("KSPEC_PIPELINE", "legacy")
    assert resolve_pipeline() == "legacy"
    monkeypatch.setenv("KSPEC_PIPELINE", "device")
    assert resolve_pipeline() == "device"
    with pytest.raises(ValueError, match="unknown pipeline"):
        resolve_pipeline("nope")
