"""PyTorch port's `cli check`: its --json record equals the JAX package's
kspec-verdict/1 record of the same .cfg (timing fields and run_id aside),
its text trace equals the JAX package's render_trace, and its exit codes
are 0 (no violation), 1 (a violation) and 2 (an error)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.service.verdict import verdict_from_result as jax_verdict
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu.utils.pretty import render_trace as jax_render_trace
from kafka_specification_tpu_torch import cli
from kafka_specification_tpu_torch.utils import pretty

REPO = Path(__file__).resolve().parents[1]
TIMING = ("seconds", "states_per_sec", "run_id")
VIOLATING_CFG = """\\* 2 replicas: TruncateToHighWatermark breaks WeakIsr at depth 8
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 1
    MaxLeaderEpoch = 1
INVARIANTS TypeOk WeakIsr
CHECK_DEADLOCK FALSE
"""


def jax_run(path, module):
    tlc = jcfg.parse_cfg(path)
    model = jcfg.build_model(module, tlc, analysis_gate=False)
    return model, jbfs.check(model, check_deadlock=tlc.check_deadlock)


def run_cli(capsys, *argv):
    rc = cli.main(["check", *map(str, argv), "--device", "cpu"])
    return rc, capsys.readouterr()


def drop_timing(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


@pytest.fixture(scope="module")
def violating(tmp_path_factory):
    """The 2-replica violating .cfg, and the JAX package's model and result
    for it."""
    path = tmp_path_factory.mktemp("cfg") / "KafkaTruncateToHighWatermark.cfg"
    path.write_text(VIOLATING_CFG)
    return (path, *jax_run(path, path.stem))


@pytest.mark.parametrize("name", ["IdSequence", "FiniteReplicatedLog"])
def test_json_record_equals_jax(capsys, name):
    path = REPO / "configs" / f"{name}.cfg"
    rc, out = run_cli(capsys, path, "--json")
    rec = json.loads(out.out)
    _, jres = jax_run(path, name)
    assert rc == 0 and rec["exit_code"] == 0
    assert drop_timing(rec) == drop_timing(jax_verdict(jres))
    assert rec["run_id"] is None


def test_violating_cfg_json_and_text_equal_jax(capsys, violating):
    violating_cfg, jmodel, jres = violating
    rc, out = run_cli(capsys, violating_cfg, "--json")
    assert rc == 1
    assert drop_timing(json.loads(out.out)) == drop_timing(jax_verdict(jres))

    rc, out = run_cli(capsys, violating_cfg)
    lines = out.out.splitlines()
    assert rc == 1
    assert lines[0] == f"Model: {jres.model}"
    assert lines[1].startswith(f"{jres.total} distinct states found, diameter {jres.diameter}, ")
    assert lines[2] == f"Invariant WeakIsr is VIOLATED at depth {jres.violation.depth}."
    assert lines[3] == "Counterexample trace:"
    assert "\n".join(lines[4:]) == jax_render_trace(jmodel.meta, jres.violation.trace)
    assert "b2 :> [hw|->" in out.out  # the .cfg's replica names


def test_render_state_equals_jax(violating):
    """The Kafka renderer with and without model-value names, and the repr
    fallback of the small models."""
    from kafka_specification_tpu.utils import pretty as jpretty

    _, jmodel, jres = violating
    state = jres.violation.state
    for meta in (jmodel.meta, {"variant": "Kip320"}, {}):
        assert pretty.render_state(meta, state) == jpretty.render_state(meta, state)
    assert pretty.render_state({}, (1, (2,))) == jpretty.render_state({}, (1, (2,)))


def test_exit_code_2_on_errors(capsys, tmp_path, monkeypatch):
    bad = tmp_path / "Kip320.cfg"
    bad.write_text("CONSTANTS\n    Replicas\n")
    rc, out = run_cli(capsys, bad)
    assert rc == 2 and "cannot parse" in out.err
    rc, out = run_cli(capsys, REPO / "configs" / "AsyncIsr.cfg")
    assert rc == 2 and "not ported" in out.err
    monkeypatch.setenv("KSPEC_PIPELINE", "device")
    rc, out = run_cli(capsys, REPO / "configs" / "IdSequence.cfg", "--json")
    rec = json.loads(out.out)
    assert rc == 2 and rec["exit_code"] == 2 and "not ported" in rec["error"]


def test_module_entry_point():
    """`python -m kafka_specification_tpu_torch.cli check` in a fresh
    process prints the record and exits with its code."""
    out = subprocess.run(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "check",
         "configs/IdSequence.cfg", "--device", "cpu", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert rec["schema"] == "kspec-verdict/1" and rec["distinct_states"] == 12
