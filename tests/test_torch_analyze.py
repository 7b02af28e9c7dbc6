"""PyTorch port's `cli analyze` and the AST half of its ownership pass,
held against the JAX package's.

The JAX package's `cli analyze` installs a stub `jax` module when jax is
not imported yet, so it runs here only in a subprocess (as its own
tests/test_analysis.py runs it); the port's runs in process.  The model
half of the record (`--no-engine`) equals JAX's on the shipped matrix and
on the edge cases (an unsound cfg, an unreadable one, `--module` with two
cfgs); the engine half is the port's own: its three THREAD_CONTRACT
modules and its two purity modules, where it finds one LOW stale
annotation and nothing else.  The port's AST checker and JAX's agree on
both packages' contract modules and on seeded mutants of each."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kafka_specification_tpu.analysis import ownership as jown
from kafka_specification_tpu_torch import analysis, cli
from kafka_specification_tpu_torch.analysis import encoding as tenc
from kafka_specification_tpu_torch.analysis import ownership as town
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PORT_OWNERSHIP = ("overlap.py", "storage/tiered.py", "resilience/checkpoints.py")
UNSOUND_CFG = (
    "SPECIFICATION Spec\nCONSTANTS\n"
    "    Replicas = {r1, r2, r3, r4, r5}\n"
    "    MaxOffset = 1\n    MaxVersion = 1\n"
    "INVARIANTS TypeOk ValidHighWatermark\n"
)


@pytest.fixture(autouse=True)
def no_state_left(monkeypatch):
    """The encoding gate's and the hulls' memos, the cwd and sys.modules'
    jax entry are as the test found them."""
    cwd, jax_mod = os.getcwd(), sys.modules.get("jax")
    monkeypatch.setattr(analysis, "_VERIFIED_MODELS", set(analysis._VERIFIED_MODELS))
    monkeypatch.setattr(tenc, "_HULLS", dict(tenc._HULLS))
    yield
    os.chdir(cwd)
    assert sys.modules.get("jax") is jax_mod


def jax_analyze(*argv):
    """JAX's `cli analyze` in a subprocess: (exit code, stdout, stderr)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom kafka_specification_tpu.utils.cli import main\n"
         "sys.exit(main(['analyze', *sys.argv[1:]]))", *map(str, argv)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    return out.returncode, out.stdout, out.stderr


def port_analyze(capsys, *argv):
    rc = cli.main(["analyze", *map(str, argv)])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_model_record_equals_jax_on_the_shipped_matrix(capsys):
    """--json --no-engine: kinds, severities, targets, messages and counts
    as JAX's, for every configs/*.cfg (the stretch cfg as Kip320)."""
    rc, out, err = port_analyze(capsys, "--json", "--no-engine")
    jrc, jout, jerr = jax_analyze("--json", "--no-engine")
    assert rc == jrc == 0, jerr[-2000:]
    rec, jrec = json.loads(out), json.loads(jout)
    assert rec == jrec
    assert rec["schema"] == "kspec-analysis/1" and rec["ok"] is True
    assert len(rec["targets"]) == len(list((REPO / "configs").glob("*.cfg")))
    assert any(t.startswith("Kip320 (") and t.endswith("Kip320Stretch.cfg)")
               for t in rec["targets"])
    # and its text form, line for line
    rc, out, _ = port_analyze(capsys, "--no-engine")
    jrc, jout, _ = jax_analyze("--no-engine")
    assert rc == jrc == 0 and out == jout
    assert out.endswith("  clean: encoding sound, frames honored, ownership contracts verified\n")


def test_port_tree_is_clean(capsys):
    """The whole port: exit 0, no HIGH or MEDIUM finding, the Kip320 and
    engine-sources targets, and the one LOW stale annotation."""
    rc, out, _ = port_analyze(capsys, "--json")
    rec = json.loads(out)
    assert rc == 0 and rec["ok"] is True
    assert rec["counts"] == {"HIGH": 0, "MEDIUM": 0, "LOW": 1, "INFO": 0}
    assert rec["targets"][-1] == "engine sources (ownership + purity)"
    assert any(t.startswith("Kip320 (") for t in rec["targets"])
    (low,) = rec["findings"]
    assert (low["kind"], low["data"]) == ("stale-annotation",
                                          {"class": "CheckpointStore", "attr": "ident_aliases"})
    rc, out, _ = port_analyze(capsys, "--no-models")
    assert rc == 0 and out.splitlines()[0] == (
        "kspec analyze: 1 target(s) — 0 high / 0 medium / 1 low / 0 info")
    rc, out, _ = port_analyze(capsys, "--no-models", "--no-engine", "--info")
    assert rc == 0 and out.splitlines()[0].startswith("kspec analyze: 0 target(s)")


def test_unsound_cfg_exit_1_with_spec_width_as_jax(capsys, tmp_path):
    """AsyncIsr at 5 replicas cannot be packed soundly: exit 1 and the
    spec-width finding, the record equal to JAX's."""
    cfg = tmp_path / "AsyncIsr.cfg"
    cfg.write_text(UNSOUND_CFG)
    rc, out, _ = port_analyze(capsys, cfg, "--json", "--no-engine")
    jrc, jout, _ = jax_analyze(cfg, "--json", "--no-engine")
    assert rc == jrc == 1
    rec = json.loads(out)
    assert rec == json.loads(jout) and rec["ok"] is False
    assert {f["kind"] for f in rec["findings"]} == {"spec-width"}
    # the text form too
    rc, out, _ = port_analyze(capsys, cfg, "--no-engine")
    jrc, jout, _ = jax_analyze(cfg, "--no-engine")
    assert rc == jrc == 1 and out == jout and "HIGH   spec-width" in out


@pytest.mark.parametrize("argv", [
    ("{tmp}/missing/IdSequence.cfg", "--json", "--no-engine"),
    ("{tmp}/Nope.cfg", "--json", "--no-engine"),
    ("configs/IdSequence.cfg", "configs/Kip320.cfg", "--module", "Kip320", "--json"),
    ("--module", "Kip320", "--json", "--no-engine"),
], ids=["unreadable", "unknown-module", "module-with-two-cfgs", "module-with-none"])
def test_exit_2_as_jax(capsys, tmp_path, argv):
    (tmp_path / "Nope.cfg").write_text("CONSTANTS\n    MaxId = 1\n")
    argv = [a.format(tmp=tmp_path) for a in argv]
    argv = [str(REPO / a) if a.startswith("configs/") else a for a in argv]
    rc, out, err = port_analyze(capsys, *argv)
    jrc, jout, jerr = jax_analyze(*argv)
    assert rc == jrc == 2
    assert (out, err) == (jout, jerr)
    if out:
        rec = json.loads(out)
        assert rec["ok"] is False and rec["findings"][0]["kind"] == "analysis-error"
    else:
        assert err.startswith("error: --module requires exactly one .cfg argument")


def test_analyze_engine_sources_finds_one_stale_annotation():
    (f,) = analysis.analyze_engine_sources()
    assert (f.kind, f.severity) == ("stale-annotation", "LOW")
    assert f.target == "kafka_specification_tpu_torch/resilience/checkpoints.py:CheckpointStore"
    assert f.data == {"class": "CheckpointStore", "attr": "ident_aliases"}
    assert analysis.OWNERSHIP_MODULES == tuple(
        f"kafka_specification_tpu_torch/{rel}" for rel in PORT_OWNERSHIP)
    assert all((REPO / rel).is_file() for rel in analysis.PURITY_MODULES)


def _records(findings):
    return [f.record() for f in findings]


@pytest.mark.parametrize("pkg", ["kafka_specification_tpu_torch", "kafka_specification_tpu"])
@pytest.mark.parametrize("rel", PORT_OWNERSHIP)
def test_ast_checker_equals_jax(pkg, rel):
    """Both checkers on both packages' contract modules: equal findings
    (JAX's modules give none; the port's the one stale annotation)."""
    path = str(REPO / pkg / rel)
    got, want = town.check_module_contract(path, rel), jown.check_module_contract(path, rel)
    assert _records(got) == _records(want)
    if pkg == "kafka_specification_tpu" or rel != "resilience/checkpoints.py":
        assert got == []


@pytest.mark.parametrize("pkg", ["kafka_specification_tpu_torch", "kafka_specification_tpu"])
def test_purity_lint_equals_jax_on_clean_modules(pkg):
    rels = ("engine/pipeline.py", "ops/devlevel.py")
    for rel in rels:
        path = str(REPO / pkg / rel)
        assert town.lint_purity(path, rel) == jown.lint_purity(path, rel) == []


def test_the_port_marks_its_device_level_functions_traced():
    """The per-chunk body of DevicePipeline.queue_level and the
    ops/devlevel.py helpers it calls are `# kspec: traced`."""
    import ast

    def traced(rel):
        path = REPO / "kafka_specification_tpu_torch" / rel
        src = path.read_text()
        return {fn.name for fn in town._traced_functions(ast.parse(src), src)}

    assert {"queue_level", "_chunk", "invariant_flags", "expand_stage", "deadlock_rows",
            "fp_masked", "chunk_novelty", "candidate_dedup_stage",
            "sorted_emit"} <= traced("engine/pipeline.py")
    assert {"masked_digest", "xor_reduce", "combine_digest", "append_slots",
            "append_rows"} <= traced("ops/devlevel.py")


def _mutant(tmp_path, pkg, rel, anchor, insert, name):
    src = (REPO / pkg / rel).read_text()
    assert src.count(anchor) == 1, (pkg, rel, anchor)
    path = tmp_path / f"{name}.py"
    path.write_text(src.replace(anchor, anchor + insert))
    return str(path)


@pytest.mark.parametrize("pkg", ["kafka_specification_tpu_torch", "kafka_specification_tpu"])
def test_seeded_worker_write_is_found_by_both(tmp_path, pkg):
    """An engine-only write (TieredFpSet.runs) inside the merge job handed
    to the AsyncWorker: HIGH ownership-breach from both checkers."""
    path = _mutant(tmp_path, pkg, "storage/tiered.py", "        def job():\n",
                   "            self.runs = []\n", "tiered_mutant")
    got = town.check_module_contract(path, "storage/tiered.py")
    want = jown.check_module_contract(path, "storage/tiered.py")
    assert _records(got) == _records(want)
    hits = [f for f in got if f.data.get("attr") == "runs"]
    assert [(f.kind, f.severity, f.data["context"]) for f in hits] == [
        ("ownership-breach", "HIGH", "worker")]
    # the allow() comment suppresses it, in both
    path = _mutant(tmp_path, pkg, "storage/tiered.py", "        def job():\n",
                   "            # kspec: allow(ownership) seeded for the test\n"
                   "            self.runs = []\n", "tiered_allowed")
    assert not [f for f in town.check_module_contract(path, "x") if f.data.get("attr") == "runs"]


@pytest.mark.parametrize("pkg", ["kafka_specification_tpu_torch", "kafka_specification_tpu"])
def test_seeded_item_in_a_traced_function_is_found_by_both(tmp_path, pkg):
    anchor = '    selected by `valid`, as int64[3]."""\n' if pkg.endswith("torch") else (
        "    :func:`combine_digest`, convert with :func:`digest_ints`.\"\"\"\n")
    path = _mutant(tmp_path, pkg, "ops/devlevel.py", anchor,
                   "    n = valid.sum().item()\n", "devlevel_mutant")
    got, want = town.lint_purity(path, "x"), jown.lint_purity(path, "x")
    assert [(f.kind, f.severity, f.data) for f in got] == [
        (f.kind, f.severity, f.data) for f in want]
    assert [(f.kind, f.severity, f.data["call"]) for f in got] == [
        ("host-materialization", "MEDIUM", ".item()")]


@pytest.mark.parametrize("call,flagged", [
    ("x = valid.cpu()", ".cpu()"),
    ("x = valid.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("x = int(valid.sum())", "int(...)"),
    ("x = np.asarray(valid)", "np.asarray"),
])
def test_the_port_lint_knows_the_torch_host_reads(tmp_path, call, flagged):
    anchor = '    selected by `valid`, as int64[3]."""\n'
    path = _mutant(tmp_path, "kafka_specification_tpu_torch", "ops/devlevel.py", anchor,
                   f"    {call}\n", "devlevel_mutant")
    (f,) = town.lint_purity(path, "ops/devlevel.py")
    assert (f.kind, f.severity, f.data["call"], f.data["function"]) == (
        "host-materialization", "MEDIUM", flagged, "masked_digest")
    # a static read, annotated, is allowed
    path = _mutant(tmp_path, "kafka_specification_tpu_torch", "ops/devlevel.py", anchor,
                   f"    # kspec: allow(host-materialization) static in this test\n    {call}\n",
                   "devlevel_allowed")
    assert town.lint_purity(path, "ops/devlevel.py") == []


def test_set_iteration_is_found(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("def f(xs):\n    for x in set(xs):\n        yield x\n")
    (f,) = town.lint_purity(str(path), "m.py")
    assert (f.kind, f.severity) == ("set-iteration-order", "MEDIUM")
    assert _records([f]) == _records(jown.lint_purity(str(path), "m.py"))


def test_a_module_without_contract_and_a_missing_class(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("class W:\n    def go(self, w):\n        w.submit('x', self.go)\n")
    assert _records(town.check_module_contract(str(path), "m.py")) == _records(
        jown.check_module_contract(str(path), "m.py"))
    shutil.copy(REPO / "kafka_specification_tpu_torch" / "overlap.py", tmp_path / "o.py")
    src = (tmp_path / "o.py").read_text().replace("class AsyncJob", "class AsyncJobRenamed")
    (tmp_path / "o.py").write_text(src)
    got = town.check_module_contract(str(tmp_path / "o.py"), "o.py")
    assert _records(got) == _records(jown.check_module_contract(str(tmp_path / "o.py"), "o.py"))
    assert ("stale-annotation", "LOW") in {(f.kind, f.severity) for f in got}
