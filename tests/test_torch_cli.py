"""PyTorch port's `cli check`: its --json record equals the JAX package's
kspec-verdict/1 record of the same .cfg (timing fields aside; the run_id
has JAX's format and is the run directory's), its text trace equals the
JAX package's render_trace, and its exit codes are 0 (no violation), 1 (a
violation) and 2 (an error), with JAX's stderr for a malformed byte
budget, an unknown module and an unknown fault; `cli faults --list`
prints JAX's grammar.  The run options
take JAX's names: --cpu, --max-states, --no-trace, --progress, --stats and
--checkpoint/--checkpoint-every/--checkpoint-keep, each held to the JAX
package's record, stats lines and checkpoint files.  AsyncIsr.cfg and the
Stretch product check; `cli simulate` prints JAX's lines and exit codes."""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.service.verdict import verdict_from_result as jax_verdict
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu.utils.pretty import render_trace as jax_render_trace
from kafka_specification_tpu.resilience import checkpoints as jckpt
from kafka_specification_tpu.utils.pretty import render_state as jax_render_state
from kafka_specification_tpu_torch import cli
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.utils import pretty
from torch_guards import overlap_guard  # noqa: F401  (autouse)

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


KIP320_2R_CFG = """\\* Kip320 with 2 replicas: 5,973 states, diameter 17
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 2
    MaxLeaderEpoch = 2
INVARIANTS TypeOk LeaderInIsr WeakIsr StrongIsr
CHECK_DEADLOCK FALSE
"""
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement")


def jax_run(path, module, **kw):
    tlc = jcfg.parse_cfg(path)
    model = jcfg.build_model(module, tlc, analysis_gate=False)
    return model, jbfs.check(model, check_deadlock=tlc.check_deadlock, **kw)


def chip_smoke():
    """chip_smoke.py's pins of the JAX package's runs at Kip320 3r."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stats_lines(path):
    with open(path) as fh:
        return [{k: json.loads(line)[k] for k in DETERMINISTIC} for line in fh]


@pytest.fixture(autouse=True)
def _runs_root(tmp_path, monkeypatch):
    """Each check's run directory lands under this test's tmp_path."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))


def run_cli(capsys, *argv):
    rc = cli.main(["check", *map(str, argv), "--device", "cpu"])
    return rc, capsys.readouterr()


@pytest.fixture(scope="module")
def kip320_2r(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "Kip320.cfg"
    path.write_text(KIP320_2R_CFG)
    return path


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
    # the run id has JAX's format and names the run directory the check opened
    assert re.fullmatch(r"\d{8}T\d{6}-%d-[0-9a-f]{4}" % os.getpid(), rec["run_id"])
    with open(os.path.join(os.environ["KSPEC_RUNS_ROOT"], rec["run_id"], "manifest.json")) as fh:
        assert json.load(fh)["run_id"] == rec["run_id"]
    assert out.err == (f"[obs] run dir: {os.environ['KSPEC_RUNS_ROOT']}/{rec['run_id']} "
                       f"(run {rec['run_id']})\n")


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
    rc, out = run_cli(capsys, REPO / "configs" / "IdSequence.cfg", "--module", "AlterPartition")
    assert rc == 2 and out.err == "error: unknown module 'AlterPartition'\n"
    monkeypatch.setenv("KSPEC_PIPELINE", "nope")
    rc, out = run_cli(capsys, REPO / "configs" / "IdSequence.cfg", "--json")
    rec = json.loads(out.out)
    assert rc == 2 and rec["exit_code"] == 2 and "unknown pipeline" in rec["error"]


def test_module_entry_point(tmp_path):
    """`python -m kafka_specification_tpu_torch.cli check` in a fresh
    process prints the record and exits with its code."""
    out = subprocess.run(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "check",
         "configs/IdSequence.cfg", "--device", "cpu", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "KSPEC_RUNS_ROOT": str(tmp_path / "runs")},
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout)
    assert rec["schema"] == "kspec-verdict/1" and rec["distinct_states"] == 12


def test_cpu_flag_equals_jax(capsys):
    """`--cpu` is `--device cpu`, as JAX's flag of that name."""
    path = REPO / "configs" / "IdSequence.cfg"
    rc = cli.main(["check", str(path), "--cpu", "--json"])
    rec = json.loads(capsys.readouterr().out)
    _, jres = jax_run(path, "IdSequence")
    assert rc == 0 and drop_timing(rec) == drop_timing(jax_verdict(jres))


def test_max_states_3r_equals_the_jax_pin(capsys, tmp_path):
    """`cli check configs/Kip320.cfg --max-states 100000 --json --stats F`:
    the JAX package's record and stats lines, as chip_smoke.py pins them
    from its `--cpu` run: cut at the first level boundary past 100,000."""
    pins = chip_smoke()
    stats = tmp_path / "stats.jsonl"
    rc = cli.main(["check", str(REPO / "configs" / "Kip320.cfg"), "--cpu", "--max-states",
                   "100000", "--json", "--stats", str(stats)])
    rec = json.loads(capsys.readouterr().out)
    assert rc == 0 and drop_timing(rec) == pins.KIP320_MAX_STATES_VERDICT
    assert stats_lines(stats) == pins.max_states_stats()


def test_max_states_stats_and_progress_equal_jax(capsys, tmp_path, kip320_2r):
    calls = []
    _, jres = jax_run(kip320_2r, "Kip320", max_states=1000, stats_path=str(tmp_path / "jax.jsonl"),
                      progress=lambda *a: calls.append(a))
    rc, out = run_cli(capsys, kip320_2r, "--max-states", 1000, "--json", "--progress",
                      "--stats", tmp_path / "port.jsonl")
    assert rc == 0 and drop_timing(json.loads(out.out)) == drop_timing(jax_verdict(jres))
    assert stats_lines(tmp_path / "port.jsonl") == stats_lines(tmp_path / "jax.jsonl")
    # the run directory's line, as JAX's CLI prints it, then the progress lines
    err = out.err.splitlines()
    assert err[0].startswith("[obs] run dir: ")
    assert err[1:] == [f"  level {d}: {n} new, {t} total" for d, n, t in calls]


def test_no_trace_equals_jax(capsys, violating):
    violating_cfg, jmodel, _ = violating
    _, jres = jax_run(violating_cfg, violating_cfg.stem, store_trace=False)
    rc, out = run_cli(capsys, violating_cfg, "--no-trace", "--json")
    rec = json.loads(out.out)
    assert rc == 1 and drop_timing(rec) == drop_timing(jax_verdict(jres))
    assert rec["violation"]["trace_len"] == 0
    rc, out = run_cli(capsys, violating_cfg, "--no-trace")
    lines = out.out.splitlines()
    assert rc == 1 and lines[3] == "Violating state:"
    assert "\n".join(lines[4:]) == jax_render_state(jmodel.meta, jres.violation.state)


def test_checkpoint_resume_equals_jax(capsys, tmp_path, kip320_2r):
    """--checkpoint with a --max-depth cut, then the same command without
    it: the uninterrupted record, and the JAX package's chain and files."""
    _, jres = jax_run(kip320_2r, "Kip320", visited_backend="host",
                      checkpoint_dir=str(tmp_path / "jax"))
    ck = tmp_path / "port"
    args = (kip320_2r, "--json", "--visited-backend", "host", "--checkpoint", ck)
    rc, out = run_cli(capsys, *args, "--max-depth", 6)
    assert rc == 0 and json.loads(out.out)["levels"] == jres.levels[:7]
    rc, out = run_cli(capsys, *args)
    assert rc == 0 and drop_timing(json.loads(out.out)) == drop_timing(jax_verdict(jres))
    port = tckpt.verify_file(str(ck / "bfs_checkpoint.npz"))
    jax_ = jckpt.verify_file(str(tmp_path / "jax" / "bfs_checkpoint.npz"))
    for key in ("digest_chain", "levels", "total", "depth", "ident", "frontier", "vcap"):
        np.testing.assert_array_equal(port[key], jax_[key], err_msg=key)
    assert sorted(os.listdir(ck)) == ["bfs_checkpoint.1.npz", "bfs_checkpoint.2.npz",
                                      "bfs_checkpoint.npz"]

    # every 4th level, one generation kept
    ck2 = tmp_path / "every4"
    rc, out = run_cli(capsys, kip320_2r, "--visited-backend", "host", "--checkpoint", ck2,
                      "--checkpoint-every", 4, "--checkpoint-keep", 1)
    assert rc == 0 and os.listdir(ck2) == ["bfs_checkpoint.npz"]
    assert int(tckpt.verify_file(str(ck2 / "bfs_checkpoint.npz"))["depth"]) == 16


def test_checkpoint_cadence_must_be_positive(capsys, kip320_2r):
    for flag in ("--checkpoint-every", "--checkpoint-keep"):
        rc, out = run_cli(capsys, kip320_2r, flag, 0)
        assert rc == 2 and "must be >= 1" in out.err


# --- AsyncIsr, the product and simulate ---------------------------------------


def test_async_isr_cfg_json_equals_jax(capsys):
    path = REPO / "configs" / "AsyncIsr.cfg"
    rc = cli.main(["check", str(path), "--cpu", "--json"])
    rec = json.loads(capsys.readouterr().out)
    _, jres = jax_run(path, "AsyncIsr")
    assert rc == 0 and drop_timing(rec) == drop_timing(jax_verdict(jres))
    assert (rec["distinct_states"], rec["diameter"]) == (4088, 16)


def test_async_isr_five_replicas_exit_2(capsys, tmp_path):
    path = tmp_path / "AsyncIsr.cfg"
    path.write_text((REPO / "configs" / "AsyncIsr.cfg").read_text().replace(
        "Replicas = {b1, b2, b3}", "Replicas = {b1, b2, b3, b4, b5}"))
    rc, out = run_cli(capsys, path)
    assert rc == 2 and "AsyncIsr supports at most 4 replicas, got 5" in out.err
    bad = tmp_path / "Kip320.cfg"
    bad.write_text(KIP320_2R_CFG + "CONSTRAINT Bounded\n")
    rc, out = run_cli(capsys, bad)
    assert rc == 2 and "only AsyncIsr's bound is defined" in out.err


def test_stretch_product_cut_at_depth_3(capsys):
    """Kip320Stretch.cfg (5 replicas x 3 partitions) with --max-depth 3:
    the levels are the closed form, the convolution of the base's."""
    from kafka_specification_tpu_torch import build_model, check, load_config

    path = REPO / "configs" / "Kip320Stretch.cfg"
    rc, out = run_cli(capsys, path, "--module", "Kip320", "--max-depth", 3, "--json")
    rec = json.loads(out.out)
    cfg = load_config(path)
    cfg.constants["Partitions"] = 1
    base = check(build_model("Kip320", cfg), device="cpu", max_depth=3).levels
    assert rc == 0 and rec["model"] == "Kip320(5r,L2,R2,E2) x3partitions"
    assert rec["levels"] == np.convolve(np.convolve(base, base), base)[:4].tolist()


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """JAX's simulate of the 3-replica TruncateToHW .cfg: 200 walks of depth
    30 from seed 0."""
    from kafka_specification_tpu.engine.simulate import simulate as jax_simulate

    path = REPO / "configs" / "KafkaTruncateToHighWatermark.cfg"
    model = jcfg.build_model(path.stem, jcfg.parse_cfg(path), analysis_gate=False)
    return path, model, jax_simulate(model, num_walks=200, max_depth=30, seed=0)


def test_simulate_violation_lines_equal_jax(capsys, simulated):
    path, jmodel, jres = simulated
    args = ["simulate", str(path), "--cpu", "--walks", "200", "--depth", "30", "--seed", "0"]
    rc = cli.main(args)
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1 and jres.violation.invariant == "WeakIsr" and jres.violation.depth == 12
    assert lines[0] == f"Model: {jres.model}"
    assert lines[1].startswith(f"{jres.total} distinct states found, diameter 0, ")
    assert jres.total == 1673
    assert lines[2] == "Invariant WeakIsr is VIOLATED at depth 12."
    assert lines[3] == "Counterexample trace:"
    assert "\n".join(lines[4:]) == jax_render_trace(jmodel.meta, jres.violation.trace)
    rc = cli.main(args + ["--json"])
    rec = json.loads(capsys.readouterr().out)
    assert rc == 1 and drop_timing(rec) == drop_timing(jax_verdict(jres))


def test_simulate_clean_line_and_errors(capsys, kip320_2r):
    from kafka_specification_tpu.engine.simulate import simulate as jax_simulate

    model = jcfg.build_model("Kip320", jcfg.parse_cfg(kip320_2r), analysis_gate=False)
    jres = jax_simulate(model, num_walks=12, max_depth=15, seed=3)
    for extra in ([], ["--json"]):
        rc = cli.main(["simulate", str(kip320_2r), "--device", "cpu", "--walks", "12",
                       "--depth", "15", "--seed", "3", *extra])
        out = capsys.readouterr().out
        assert rc == 0 and out.startswith(
            f"Simulation: 12 walks x depth 15, {jres.total} states visited, no violations (")
        assert out.endswith(" states/sec).\n") and len(out.splitlines()) == 1
    rc = cli.main(["simulate", str(kip320_2r), "--cpu", "--module", "Nope"])
    assert rc == 2 and capsys.readouterr().err == "error: unknown module 'Nope'\n"


def jax_cli(capsys, *argv):
    from kafka_specification_tpu.utils.cli import main as jmain

    try:
        rc = jmain(list(map(str, argv)))
    except SystemExit as e:  # its model-building refusals exit this way
        rc = e.code
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("flag", ["--mem-budget", "--disk-budget"])
def test_malformed_byte_budget_equals_jax(capsys, flag):
    """A malformed budget is refused before the model is built: exit 2,
    JAX's stderr, and nothing on stdout even under --json."""
    path = REPO / "configs" / "IdSequence.cfg"
    rc, out = run_cli(capsys, path, "--json", flag, "12Q")
    jrc, jout = jax_cli(capsys, "check", path, "--cpu", "--hand", "--json", flag, "12Q")
    assert rc == jrc == 2
    assert out.out == jout.out == ""
    assert out.err == jout.err and out.err.startswith("error: bad ")
    assert not os.path.exists(os.environ["KSPEC_RUNS_ROOT"])  # no run was opened


@pytest.mark.parametrize("plan", ["bogus@x:1", "crash@lvl:3", "bogus"])
def test_unknown_fault_equals_jax(capsys, plan):
    """The refusal points at `cli faults --list`, as JAX's does."""
    path = REPO / "configs" / "IdSequence.cfg"
    rc, out = run_cli(capsys, path, "--json", "--fault", plan)
    jrc, jout = jax_cli(capsys, "check", path, "--cpu", "--hand", "--json", "--fault", plan)
    assert rc == jrc == 2 and out.out == jout.out == ""
    assert out.err == jout.err and "`cli faults --list`" in out.err
    assert "KSPEC_FAULT" not in os.environ


def test_unknown_module_equals_jax(capsys):
    path = REPO / "configs" / "Kip320Stretch.cfg"
    rc, out = run_cli(capsys, path, "--json")
    jrc, jout = jax_cli(capsys, "check", path, "--cpu", "--hand", "--json")
    assert rc == jrc == 2 and out.out == jout.out == ""
    assert out.err == jout.err == "error: unknown module 'Kip320Stretch'\n"


def test_faults_list_equals_jax(capsys):
    """`cli faults --list` prints JAX's grammar, entry for entry (JAX's
    listing then goes on to its crash-consistency scenarios, which the
    port does not have yet); --json lists the same registry entries."""
    assert cli.main(["faults", "--list"]) == 0
    out = capsys.readouterr().out
    jrc, jout = jax_cli(capsys, "faults", "--list")
    assert jrc == 0
    head = jout.out.split("\n\nCrashcheck scenarios", 1)[0]
    assert out == head + "\n" and out.count("\n      ") == 10  # ten kinds
    assert cli.main(["faults", "--json"]) == 0
    entries = json.loads(capsys.readouterr().out)
    jrc, jout = jax_cli(capsys, "faults", "--json")
    assert entries == [e for e in json.loads(jout.out) if e["kind"] != "crashcheck-scenario"]


# --- cli pipelines: the registry against the JAX package's support matrix ---------------


def test_pipelines_json_equals_jax_support_matrix(capsys):
    """Names, order, default, each entry's fallback, every backend cell's
    flag and the (device, device-hash) detail are JAX's; the port's
    sharded engine cells say they are not served."""
    from kafka_specification_tpu.pipeline_registry import list_pipelines as jax_list
    from kafka_specification_tpu_torch import pipeline_registry as reg

    assert cli.main(["pipelines", "--json"]) == 0
    entries = json.loads(capsys.readouterr().out)
    jentries = jax_list()
    assert entries == reg.list_pipelines()
    assert [e["name"] for e in entries] == [e["name"] for e in jentries] == list(reg.PIPELINES)
    for e, j in zip(entries, jentries):
        assert (e["default"], e["fallback"]) == (j["default"], j["fallback"])
        assert list(e["backends"]) == list(j["backends"])
        assert set(e["backends"]) == set(reg.BACKENDS)
        assert list(e["engines"]) == list(j["engines"]) == list(reg.ENGINES)
        for be in reg.BACKENDS:
            assert e["backends"][be]["supported"] == j["backends"][be]["supported"]
            assert reg.backend_support(e["name"], be) == e["backends"][be]
        assert e["engines"]["single-device"]["supported"] is True
        assert e["engines"]["sharded"]["supported"] is False
        assert "no sharded engine" in e["engines"]["sharded"]["detail"]
        assert reg.engine_support(e["name"], "sharded") == e["engines"]["sharded"]
    dh, jdh = entries[0]["backends"]["device-hash"], jentries[0]["backends"]["device-hash"]
    assert dh == jdh
    assert reg.DEVICE_HASH_REASON == f"visited backend 'device-hash': {jdh['detail']}"
    assert reg.DEFAULT_PIPELINE == "fused"
    from kafka_specification_tpu.pipeline_registry import pipeline_names as jax_names

    assert reg.pipeline_names() == jax_names()
    with pytest.raises(ValueError, match="unknown visited backend"):
        reg.backend_support("device", "disk")
    with pytest.raises(ValueError, match="unknown engine"):
        reg.engine_support("device", "multi-host")
    with pytest.raises(ValueError, match="unknown pipeline"):
        reg.backend_support("mega", "host")


def test_pipelines_text_has_jax_layout(capsys):
    """One line per entry, its description, then one [engine] and one
    [backend b] line per cell, as JAX's `cli pipelines` prints them; the
    marks agree except on the sharded cells the port does not serve."""
    from kafka_specification_tpu.utils.cli import main as jmain

    assert cli.main(["pipelines"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert jmain(["pipelines", "--list"]) == 0
    jout = capsys.readouterr().out.splitlines()
    assert len(out) == len(jout) == 1 + 3 * (2 + 2 + 3)

    def head(line):
        s = line.strip()
        if s.startswith("["):
            return s.split(":", 1)[0]
        return s.split(":", 1)[0] if line.startswith("  ") and not line.startswith("      ") \
            else "description"

    assert out[0] == jout[0]
    for a, b in zip(out[1:], jout[1:]):
        if "[sharded]" in a:
            assert a.startswith("      [sharded] degrades: the port has no sharded engine")
            continue
        assert head(a) == head(b), (a, b)
    assert out[1] == ("  device: one K1 launch per chunk, one host read per LEVEL -> "
                      "degrades to 'fused'")
    assert cli.main(["pipelines", "--list"]) == 0
    assert capsys.readouterr().out.splitlines() == out
