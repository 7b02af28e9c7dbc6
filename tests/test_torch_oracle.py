"""PyTorch port's reference interpreter (``oracle/``) and its model oracles,
held against the JAX package's: the same oracle_bfs on each model's
set-semantics twin gives the same per-level counts, per-level state SETS,
totals, diameters, violations and traces, compared with ``==`` (the states
are the same canonical Python values in both packages).  Then the port's
engine on the CPU, on every visited backend and on pipeline="device",
against the port's oracle, level set for level set (as the JAX package's
``tests/helpers.py::assert_matches_oracle`` holds its engine), and
``cli oracle`` against the JAX package's ``cli oracle``, line for line
with the timing field aside."""

import re
from pathlib import Path

import pytest

from kafka_specification_tpu.models import async_isr as jasync
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kip320 as jkip
from kafka_specification_tpu.models import variants as jvar
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.models.product import product_oracle as jproduct_oracle
from kafka_specification_tpu.oracle.interp import oracle_bfs as jax_oracle_bfs
from kafka_specification_tpu_torch import check, cli
from kafka_specification_tpu_torch.engine.decode import decode_levels
from kafka_specification_tpu_torch.models import async_isr as tasync
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kip320 as tkip
from kafka_specification_tpu_torch.models import variants as tvar
from kafka_specification_tpu_torch.models.kafka_replication import Config as TConfig
from kafka_specification_tpu_torch.models.product import product_model, product_oracle
from kafka_specification_tpu_torch.oracle import oracle_bfs
from kafka_specification_tpu_torch.utils.cfg import build_model, parse_cfg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY = (2, 2, 1, 1)
SMALL = (2, 2, 2, 2)
ALL_INVS = ("TypeOk", "LeaderInIsr", "WeakIsr", "StrongIsr")
WEAK = ("TypeOk", "WeakIsr")


def _variant(name, size, invs):
    return (lambda: tvar.make_oracle(name, TConfig(*size), invs),
            lambda: jvar.make_oracle(name, JConfig(*size), invs))


# id -> (port oracle, JAX oracle, oracle_bfs keywords, expected (total, diameter, violation))
ORACLES = {
    **{f"IdSequence({n})": (lambda n=n: tids.make_oracle(n), lambda n=n: jids.make_oracle(n),
                            {}, (n + 2, n + 1, None)) for n in (2, 3, 4)},
    "FRL(2,2,2)": (lambda: tfrl.make_oracle(2, 2, 2), lambda: jfrl.make_oracle(2, 2, 2), {},
                   (7 ** 2, None, None)),
    "FRL(3,4,1)": (lambda: tfrl.make_oracle(3, 4, 1), lambda: jfrl.make_oracle(3, 4, 1), {},
                   (5 ** 3, None, None)),
    **{f"{v} TINY TypeOk": (*_variant(v, TINY, ("TypeOk",)), {},
                            (353 if v == "KafkaTruncateToHighWatermark" else 341, 11, None))
       for v in ("KafkaTruncateToHighWatermark", "Kip101", "Kip279")},
    "TruncateToHW TINY WeakIsr": (*_variant("KafkaTruncateToHighWatermark", TINY, WEAK), {},
                                  (None, 8, ("WeakIsr", 8))),
    "Kip101 TINY WeakIsr": (*_variant("Kip101", TINY, WEAK), {}, (None, None, None)),
    "Kip101 SMALL WeakIsr": (*_variant("Kip101", SMALL, WEAK), {}, (None, 11, ("WeakIsr", 11))),
    "Kip279 SMALL": (*_variant("Kip279", SMALL, ("TypeOk", "WeakIsr", "StrongIsr")), {},
                     (9027, 17, None)),
    "Kip320 TINY": (lambda: tkip.make_oracle(TConfig(*TINY), ALL_INVS),
                    lambda: jkip.make_oracle(JConfig(*TINY), ALL_INVS), {}, (277, None, None)),
    "Kip320FirstTry TINY": (lambda: tkip.make_first_try_oracle(TConfig(*TINY), ALL_INVS),
                            lambda: jkip.make_first_try_oracle(JConfig(*TINY), ALL_INVS), {},
                            (337, None, None)),
    **{f"AsyncIsr{size}": (lambda s=size: tasync.make_oracle(tasync.AsyncIsrConfig(*s)),
                           lambda s=size: jasync.make_oracle(jasync.AsyncIsrConfig(*s)), {},
                           (None, None, None)) for size in ((3, 1, 1), (3, 2, 2))},
    "IdSequence(2) x3": (lambda: product_oracle(tids.make_oracle(2), 3),
                         lambda: jproduct_oracle(jids.make_oracle(2), 3), {}, (4 ** 3, None, None)),
    "TruncateToHW TINY x2": (
        lambda: product_oracle(tvar.make_oracle("KafkaTruncateToHighWatermark",
                                                TConfig(*TINY), ("TypeOk",)), 2),
        lambda: jproduct_oracle(jvar.make_oracle("KafkaTruncateToHighWatermark",
                                                 JConfig(*TINY), ("TypeOk",)), 2),
        {}, (353 * 353, None, None)),
    # TLC's CHECK_DEADLOCK: the chain's last state has no successor
    "IdSequence(3) deadlock": (lambda: tids.make_oracle(3), lambda: jids.make_oracle(3),
                               {"check_deadlock": True}, (5, 4, ("Deadlock", 4))),
    "Kip320 TINY max_states": (lambda: tkip.make_oracle(TConfig(*TINY), ALL_INVS),
                               lambda: jkip.make_oracle(JConfig(*TINY), ALL_INVS),
                               {"max_states": 100}, (None, None, None)),
    "FRL(2,2,2) max_depth": (lambda: tfrl.make_oracle(2, 2, 2), lambda: jfrl.make_oracle(2, 2, 2),
                             {"max_depth": 2}, (None, 2, None)),
    "TruncateToHW TINY WeakIsr no stop": (
        *_variant("KafkaTruncateToHighWatermark", TINY, WEAK),
        {"stop_on_violation": False, "keep_level_sets": False}, (353, 11, None)),
}


@pytest.mark.parametrize("case", list(ORACLES))
def test_oracle_equals_jax(case):
    tmake, jmake, kw, (total, diameter, violation) = ORACLES[case]
    tm, jm = tmake(), jmake()
    assert tm.name == jm.name
    assert [a.name for a in tm.actions] == [a.name for a in jm.actions]
    assert [n for n, _ in tm.invariants] == [n for n, _ in jm.invariants]
    t, j = oracle_bfs(tm, **kw), jax_oracle_bfs(jm, **kw)
    assert t.levels == j.levels
    assert t.level_sets == j.level_sets
    assert (t.total, t.diameter, t.violation, t.trace) == (j.total, j.diameter, j.violation,
                                                           j.trace)
    assert t.ok == j.ok
    if total is not None:
        assert t.total == total
    if diameter is not None:
        assert t.diameter == diameter
    assert (t.violation[:2] if t.violation else None) == violation
    if violation is not None:
        assert t.trace[0][0] == "<init>" and len(t.trace) == violation[1] + 1
    if "max_states" in kw:
        assert t.total >= kw["max_states"]
    if not kw.get("keep_level_sets", True):
        assert t.level_sets == []


def test_oracle_twin_carries_the_jax_meta():
    """Each oracle's meta is what utils/pretty.py::render_trace reads."""
    for module in ("Kip320", "Kip320FirstTry", "KafkaTruncateToHighWatermark", "AsyncIsr"):
        path = REPO / "configs" / f"{module}.cfg"
        om = build_model(module, parse_cfg(path), oracle=True)
        assert om.meta["variant"] == module
        assert om.meta["replica_names"] == ["b1", "b2", "b3"]
    om = build_model("Kip320", parse_cfg(REPO / "configs" / "Kip320Stretch.cfg"), oracle=True)
    assert (om.meta["partitions"], om.meta["base"]) == (3, "Kip320-oracle")
    assert len(om.actions) == 27
    # an oracle twin takes no encoding gate: the AsyncIsr cliff still holds
    cfg = parse_cfg(REPO / "configs" / "AsyncIsr.cfg")
    cfg.constants["Replicas"] = ["b1", "b2", "b3", "b4", "b5"]
    with pytest.raises(ValueError, match="at most 4 replicas"):
        build_model("AsyncIsr", cfg, oracle=True)


# --- the port's engine against the port's oracle ------------------------------------------


def assert_matches_oracle(model, oracle, **kw):
    """The port's engine on the CPU and the port's oracle: the same verdict
    and the same per-level state sets (up to the violation level on a
    violation), as the JAX package's tests/helpers.py holds its engine."""
    ores = oracle_bfs(oracle)
    packed = []
    res = check(model, device="cpu", collect_levels=packed, **kw)
    levels = decode_levels(model, packed)
    if ores.violation is None:
        assert res.violation is None, res.violation
        assert res.levels == ores.levels and res.total == ores.total
        assert len(levels) == len(ores.level_sets)
        for d, (eng, orc) in enumerate(zip(levels, ores.level_sets)):
            assert eng == orc, (f"level {d}: engine-only {list(eng - orc)[:3]} "
                                f"oracle-only {list(orc - eng)[:3]}")
    else:
        assert res.violation is not None, f"oracle found {ores.violation}, engine none"
        assert (res.violation.invariant, res.violation.depth) == ores.violation[:2]
        for d in range(ores.violation[1] + 1):
            assert levels[d] == ores.level_sets[d], f"level {d} differs"
    return res, ores


# JAX's device-pipeline test knobs: small enough that levels run device-resident
DEVICE_KNOBS = dict(pipeline="device", min_bucket=32, chunk_size=256, compact_gate=32)
PATHS = {
    "device": {},
    "device-hash": dict(visited_backend="device-hash"),
    "host": dict(visited_backend="host"),
    "pipeline device": DEVICE_KNOBS,
    "pipeline device host": dict(DEVICE_KNOBS, visited_backend="host"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_equals_oracle_passing(path):
    cfg = TConfig(*TINY)
    res, ores = assert_matches_oracle(tkip.make_model(cfg, ALL_INVS),
                                      tkip.make_oracle(cfg, ALL_INVS), **PATHS[path])
    assert res.ok and res.total == 277
    if path.startswith("pipeline"):
        assert res.stats["device"]["levels"] > 0 and res.stats["device"]["fallback"] is None


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_equals_oracle_violating(path):
    cfg = TConfig(*TINY)
    res, ores = assert_matches_oracle(
        tvar.make_model("KafkaTruncateToHighWatermark", cfg, WEAK),
        tvar.make_oracle("KafkaTruncateToHighWatermark", cfg, WEAK), **PATHS[path])
    assert (res.violation.invariant, res.violation.depth) == ("WeakIsr", 8)
    assert len(res.violation.trace) == 9


def test_engine_equals_oracle_on_async_isr_and_a_product():
    """The small cousins of chip_smoke.py phase `oracle`'s AsyncIsr run (on
    the host set) and its product run (TruncateToHW 2r (TypeOk, WeakIsr)
    x 2 on pipeline="device": WeakIsr at depth 8)."""
    acfg = tasync.AsyncIsrConfig(3, 1, 1)
    res, _ = assert_matches_oracle(tasync.make_model(acfg), tasync.make_oracle(acfg),
                                   visited_backend="host")
    assert res.ok
    cfg = TConfig(*TINY)
    base = tvar.make_model("KafkaTruncateToHighWatermark", cfg, WEAK)
    obase = tvar.make_oracle("KafkaTruncateToHighWatermark", cfg, WEAK)
    res, ores = assert_matches_oracle(product_model(base, 2), product_oracle(obase, 2),
                                      **DEVICE_KNOBS)
    assert (res.violation.invariant, res.violation.depth) == ("WeakIsr", 8)
    assert res.levels == [1, 8, 44, 172, 520, 1276, 2588, 4488, 6900]


def test_decode_levels_is_row_order_and_empty_safe():
    from kafka_specification_tpu_torch.engine.decode import decode_rows

    m = tids.make_model(3)
    packed = []
    check(m, device="cpu", collect_levels=packed)
    assert [decode_rows(m, p) for p in packed] == [[i] for i in range(5)]
    assert decode_rows(m, packed[0][:0]) == []


# --- cli oracle, port against JAX ----------------------------------------------------------


def _no_rate(text):
    # the timing field: "..., diameter D, 1.23s (45,678 states/sec)"
    return re.sub(r", [0-9.]+s \([0-9,]+ states/sec\)", ", <t>", text)


@pytest.mark.parametrize("argv", [
    ["configs/IdSequence.cfg"],
    ["configs/FiniteReplicatedLog.cfg"],
    ["configs/KafkaTruncateToHighWatermark.cfg"],
    ["configs/Kip320.cfg", "--max-states", "20000"],
    ["configs/AsyncIsr.cfg", "--max-depth", "5"],
    ["configs/IdSequence.cfg", "--module", "Nope"],
    ["configs/NoSuch.cfg"],
], ids=lambda a: " ".join(a))
def test_cli_oracle_equals_jax(capsys, argv):
    from kafka_specification_tpu.utils.cli import main as jmain

    argv = [str(REPO / argv[0]), *argv[1:]]
    rc = cli.main(["oracle", *argv])
    out = capsys.readouterr()
    try:
        jrc = jmain(["oracle", *argv])
    except SystemExit as e:  # its model-building refusals exit this way
        jrc = e.code
    jout = capsys.readouterr()
    assert rc == jrc
    assert _no_rate(out.out) == _no_rate(jout.out)
    assert out.err == jout.err
    if rc == 2:
        assert out.out == "" and out.err.startswith("error: ")
    else:
        assert out.out.startswith("Oracle: ") and " states/sec)\n" in out.out
        last = "No invariant violations. Exhaustive check complete."
        assert (rc == 0) == (last in out.out)
    if "KafkaTruncateToHighWatermark" in argv[0]:
        assert rc == 1 and "Invariant WeakIsr is VIOLATED at depth 8." in out.out
        assert "Counterexample trace:\nState 1: <Initial predicate>" in out.out
        assert "replicaLog = (b1 :> <<>>" in out.out


def test_cli_oracle_honours_check_deadlock(capsys, tmp_path):
    cfg = tmp_path / "IdSequence.cfg"
    cfg.write_text((REPO / "configs" / "IdSequence.cfg").read_text()
                   .replace("CHECK_DEADLOCK FALSE", "CHECK_DEADLOCK TRUE"))
    from kafka_specification_tpu.utils.cli import main as jmain

    assert cli.main(["oracle", str(cfg)]) == 1
    out = capsys.readouterr().out
    assert "Invariant Deadlock is VIOLATED at depth 11." in out
    assert jmain(["oracle", str(cfg)]) == 1
    assert _no_rate(capsys.readouterr().out) == _no_rate(out)
