"""PyTorch port: check(device="cpu") against the JAX engine's check() with
the same knobs (device-hash visited set, legacy full-lattice step, passed
to both: the port's defaults are the JAX package's sorted set and fused
pipeline, tests/test_torch_pipeline.py): level counts, every level's rows
in discovery order, the first violation and its trace, decoded states
included."""

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu_torch import check, interop
from kafka_specification_tpu_torch.engine import bfs as tbfs
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models import variants as tvariants
from torch_guards import overlap_guard  # noqa: F401  (autouse)

JAX_KNOBS = dict(visited_backend="device-hash", pipeline="legacy", compact_shift=0)


def run_both(jmodel, tmodel, **kw):
    jl, tl = [], []
    jr = jbfs.check(jmodel, collect_levels=jl, **JAX_KNOBS, **kw)
    tr = check(tmodel, device="cpu", collect_levels=tl, **JAX_KNOBS, **kw)
    assert tr.levels == jr.levels
    assert (tr.total, tr.diameter) == (jr.total, jr.diameter)
    assert len(tl) == len(jl)
    for d, (t, j) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(interop.to_u32(t), np.asarray(j), err_msg=f"level {d}")
    return jr, tr


def test_kip320_two_brokers_chunked():
    """Kip320 2r L2 R2 E2 through 64-row chunks: every level equal, row for
    row, to the JAX engine's."""
    cfg = (2, 2, 2, 2)
    jr, tr = run_both(
        jkip320.make_model(jkr.Config(*cfg)),
        tkip320.make_model(tkr.Config(*cfg)),
        chunk_size=64,
        min_bucket=64,
    )
    assert tr.ok and tr.total == 5973 and tr.diameter == 17
    assert tr.levels == [1, 4, 12, 32, 66, 136, 224, 360, 510, 688, 846, 900,
                         848, 660, 408, 204, 68, 6]


def test_kip101_with_table_growth(monkeypatch):
    """Kip101 2r L2 R1 E1 (341 states) from a 64-slot table in both
    packages, so the table doubles again and again mid-level."""
    monkeypatch.setattr(jbfs, "_HASH_MIN_CAP", 64)
    monkeypatch.setattr(tbfs, "_HASH_MIN_CAP", 64)
    cfg, invs = (2, 2, 1, 1), ("TypeOk",)
    jr, tr = run_both(
        jvariants.make_model("Kip101", jkr.Config(*cfg), invs),
        tvariants.make_model("Kip101", tkr.Config(*cfg), invs),
        min_bucket=32,
    )
    assert tr.ok and tr.total == 341 and tr.diameter == 11
    assert jr.stats["hash_table_capacity"] == tr.stats["hash_table_capacity"]


def test_truncate_to_hw_violation_and_trace():
    """TruncateToHW 2r L2 R1 E1 breaks WeakIsr at depth 8: same invariant,
    depth and trace, action by action and state by state."""
    cfg, invs = (2, 2, 1, 1), ("TypeOk", "WeakIsr")
    name = "KafkaTruncateToHighWatermark"
    jr, tr = run_both(
        jvariants.make_model(name, jkr.Config(*cfg), invs),
        tvariants.make_model(name, tkr.Config(*cfg), invs),
    )
    assert tr.violation is not None
    assert (tr.violation.invariant, tr.violation.depth) == ("WeakIsr", 8)
    assert tr.violation.trace == jr.violation.trace
    assert [a for a, _ in tr.violation.trace] == [
        "<init>", "ControllerElectLeader", "ControllerShrinkIsr", "BecomeLeader",
        "LeaderWrite", "BecomeFollowerTruncateToHighWatermark",
        "FollowerReplicate", "LeaderIncHighWatermark",
        "BecomeFollowerTruncateToHighWatermark",
    ]
    assert tr.violation.state == jr.violation.state


def test_deadlock_matches_jax():
    """CHECK_DEADLOCK: the bounded models deadlock by design once ids run
    out; both packages report the same first deadlocked state and trace."""
    cfg, invs = (2, 2, 1, 1), ("TypeOk",)
    jr, tr = run_both(
        jvariants.make_model("Kip279", jkr.Config(*cfg), invs),
        tvariants.make_model("Kip279", tkr.Config(*cfg), invs),
        check_deadlock=True,
    )
    assert tr.violation is not None and tr.violation.invariant == "Deadlock"
    assert tr.violation.depth == jr.violation.depth
    assert tr.violation.trace == jr.violation.trace


def test_kip279_known_answer():
    """Kip279 2r L2 R2 E2 passes WeakIsr and StrongIsr over 9,027 states,
    diameter 17 (the count the JAX package's oracle pins in
    tests/test_variants.py)."""
    invs = ("TypeOk", "WeakIsr", "StrongIsr")
    r = check(tvariants.make_model("Kip279", tkr.Config(2, 2, 2, 2), invs), device="cpu")
    assert r.ok and r.total == 9027 and r.diameter == 17


def test_max_depth_and_violation_at_init():
    """A cut run checks the unexpanded frontier; LeaderInIsrLiteral fails at
    Init (leader = None), as in the JAX engine."""
    cfg = tkr.Config(2, 2, 2, 2)
    r = check(tkip320.make_model(cfg), device="cpu", max_depth=3)
    assert r.ok and r.levels == [1, 4, 12, 32]
    r = check(tkip320.make_model(cfg, ("TypeOk", "LeaderInIsrLiteral")), device="cpu")
    assert r.violation.invariant == "LeaderInIsrLiteral"
    assert r.violation.depth == 0 and [a for a, _ in r.violation.trace] == ["<init>"]


def test_rejects_unported_backend():
    """An unknown visited backend raises, naming what there is; the
    device-resident pipeline on the device-hash backend runs the per-chunk
    path, records the JAX package's reason and runs no level on the card."""
    from kafka_specification_tpu.pipeline_registry import backend_fallback_reason

    model = tkip320.make_model(tkr.Config(2, 2, 1, 1))
    with pytest.raises(ValueError, match="one of device, device-hash, host.*'disk'"):
        check(model, device="cpu", visited_backend="disk")
    r = check(model, device="cpu", pipeline="device", visited_backend="device-hash")
    assert r.ok and r.total == 277 and r.stats["pipeline"] == "device"
    assert r.stats["device"] == {
        "levels": 0, "fallback": backend_fallback_reason("device", "device-hash")}
