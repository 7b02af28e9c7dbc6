"""PyTorch port: it imports no JAX and nothing of the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.models import kip320
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.ops import build
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "kafka_specification_tpu")


def test_import_and_tiny_check_load_no_jax(tmp_path):
    code = textwrap.dedent(
        """
        import importlib, os, pkgutil, sys
        import kafka_specification_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from kafka_specification_tpu_torch import build_model, check, load_config
        cfg = load_config("configs/Kip101.cfg")
        cfg.constants.update(MaxRecords=1, MaxLeaderEpoch=1)
        cfg.invariants = ["TypeOk"]
        res = check(build_model("Kip101", cfg), device="cpu")
        assert res.ok and res.total == 341, res
        res = check(build_model("Kip101", cfg), device="cpu", pipeline="device",
                    min_bucket=32, chunk_size=256, compact_gate=32)
        assert res.ok and res.total == 341 and res.stats["device"]["fallback"] is None, res
        from kafka_specification_tpu_torch import cli
        assert cli.main(["check", "configs/IdSequence.cfg", "--device", "cpu", "--json"]) == 0
        # AsyncIsr, the partition product and simulate
        assert cli.main(["check", "configs/AsyncIsr.cfg", "--cpu", "--json"]) == 0
        assert cli.main(["check", "configs/Kip320Stretch.cfg", "--module", "Kip320", "--cpu",
                         "--max-depth", "1"]) == 0
        assert cli.main(["simulate", "configs/KafkaTruncateToHighWatermark.cfg", "--cpu",
                         "--walks", "3", "--depth", "5"]) == 0
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            # the host set, checkpoints, the chain and the stats stream
            assert cli.main(["check", "configs/IdSequence.cfg", "--cpu", "--json",
                             "--visited-backend", "host", "--checkpoint", tmp + "/ck",
                             "--stats", tmp + "/stats.jsonl"]) == 0
            # the disk tier, the governor's exit 75, the offline verifier
            assert cli.main(["check", "configs/IdSequence.cfg", "--cpu", "--json",
                             "--mem-budget", "64", "--checkpoint", tmp + "/disk",
                             "--fault", "enospc@spill:1"]) == 75
            os.environ.pop("KSPEC_FAULT")  # --fault exported it, as JAX's CLI does
            assert cli.main(["verify-checkpoint", tmp + "/disk", "--json"]) == 0
            assert cli.main(["check", "configs/IdSequence.cfg", "--cpu", "--json",
                             "--mem-budget", "64", "--checkpoint", tmp + "/disk"]) == 0
            # the run context: a run directory, its report, the fault grammar
            assert cli.main(["check", "configs/IdSequence.cfg", "--cpu", "--json",
                             "--run-dir", tmp + "/run"]) == 0
            assert sorted(os.listdir(tmp + "/run")) == [
                "manifest.json", "metrics.jsonl", "metrics.prom", "spans.jsonl",
                "stats.jsonl"]
            assert cli.main(["report", tmp + "/run"]) == 0
            assert cli.main(["faults", "--list"]) == 0
        # the sharded engine, in process and through the CLI
        from kafka_specification_tpu_torch.models import finite_replicated_log as frl
        from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded
        res = check_sharded(frl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32)
        assert res.ok and res.total == 49, res
        # its compressed exchange (ops/fpcompress.py) and its disk tier
        os.environ["KSPEC_EXCHANGE_COMPRESS"] = "1"
        res = check_sharded(frl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=32,
                            mem_budget=64)
        os.environ.pop("KSPEC_EXCHANGE_COMPRESS")
        assert res.ok and res.total == 49 and res.stats["exchange_compressed"], res
        # its device-resident level
        res = check_sharded(frl.make_model(2, 2, 2), mesh=ShardMesh(4, "cpu"), min_bucket=8,
                            compact_gate=8, pipeline="device")
        assert res.ok and res.total == 49 and res.stats["device"]["levels"] > 0, res
        assert cli.main(["check", "configs/IdSequence.cfg", "--sharded", "--cpu", "--json"]) == 0
        # the reference interpreter, the pipeline registry, the static analysis
        assert cli.main(["oracle", "configs/IdSequence.cfg"]) == 0
        assert cli.main(["pipelines", "--json"]) == 0
        assert cli.main(["analyze", "--no-models"]) == 0
        for name in ("cli", "verdict", "pipeline_registry", "engine.pipeline",
                     "utils.pretty", "models.id_sequence", "models.finite_replicated_log",
                     "durable_io", "native", "resilience.integrity",
                     "resilience.checkpoints", "resilience.heartbeat",
                     "models.async_isr", "models.product", "engine.simulate",
                     "storage", "storage.atomic", "storage.bloom", "storage.runs",
                     "storage.frontier", "storage.parent_log", "storage.tiered",
                     "storage.store", "resilience.faults",
                     "resilience.resources", "obs", "obs.atomicio", "obs.tracer",
                     "obs.metrics", "obs.runctx", "obs.observer", "obs.report",
                     "overlap", "analysis.ownership", "oracle", "oracle.interp",
                     "engine.decode", "resilience.retry", "resilience.supervisor",
                     "utils.clock", "obs.fleettrace", "service", "service.queue",
                     "service.verdict", "service.kernel_cache", "service.scheduler",
                     "service.batch", "service.state_cache", "service.daemon",
                     "service.fleet", "service.router", "sweep", "sweep.lattice",
                     "sweep.cost", "sweep.portfolio", "sweep.bisect",
                     "analysis.durable_lint", "analysis.clock_lint",
                     "resilience.crashcheck", "resilience.crashcheck.fsmodel",
                     "resilience.crashcheck.harness", "resilience.crashcheck.scenarios",
                     "resilience.simfleet", "resilience.simfleet.kernel",
                     "resilience.simfleet.oracles", "resilience.simfleet.search",
                     "resilience.simfleet.simclock", "parallel", "parallel.multihost",
                     "parallel.sharded", "ops.fpcompress"):
            assert "kafka_specification_tpu_torch." + name in sys.modules, name
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "kafka_specification_tpu")
        )
        assert not bad, bad
        print("clean")
        """
    )
    # every run directory of the checks without --run-dir lands under tmp_path
    env = {**os.environ, "KSPEC_RUNS_ROOT": str(tmp_path / "runs")}
    env.pop("KSPEC_FAULT", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / "kafka_specification_tpu_torch").rglob("*.py"))
    # the copies of the JAX package's jax-free modules are scanned too
    names = {str(f.relative_to(REPO / "kafka_specification_tpu_torch")) for f in files}
    assert {"durable_io.py", "native/__init__.py", "resilience/integrity.py",
            "resilience/checkpoints.py", "resilience/heartbeat.py", "models/async_isr.py",
            "models/product.py", "engine/simulate.py", "analysis/__init__.py",
            "analysis/interval.py", "analysis/encoding.py", "ops/devlevel.py",
            "storage/__init__.py", "storage/atomic.py", "storage/bloom.py", "storage/runs.py",
            "storage/frontier.py", "storage/parent_log.py", "storage/tiered.py",
            "storage/store.py",
            "resilience/faults.py", "resilience/resources.py", "obs/__init__.py",
            "obs/atomicio.py", "obs/tracer.py", "obs/metrics.py", "obs/runctx.py",
            "obs/observer.py", "obs/report.py", "overlap.py", "analysis/ownership.py",
            "oracle/__init__.py", "oracle/interp.py", "engine/decode.py",
            "pipeline_registry.py", "resilience/retry.py", "resilience/supervisor.py",
            "utils/clock.py", "obs/fleettrace.py", "service/__init__.py", "service/queue.py",
            "service/verdict.py", "service/kernel_cache.py", "service/scheduler.py",
            "service/batch.py", "service/state_cache.py", "service/daemon.py",
            "service/fleet.py", "service/router.py", "sweep/__init__.py", "sweep/lattice.py",
            "sweep/cost.py", "sweep/portfolio.py", "sweep/bisect.py",
            "analysis/durable_lint.py", "analysis/clock_lint.py",
            "resilience/crashcheck/__init__.py", "resilience/crashcheck/fsmodel.py",
            "resilience/crashcheck/harness.py", "resilience/crashcheck/scenarios.py",
            "resilience/simfleet/__init__.py", "resilience/simfleet/kernel.py",
            "resilience/simfleet/oracles.py", "resilience/simfleet/search.py",
            "resilience/simfleet/simclock.py", "parallel/__init__.py",
            "parallel/multihost.py", "parallel/sharded.py", "ops/fpcompress.py"} <= names
    files.append(REPO / "chip_smoke.py")
    # the port's scripts
    files += [REPO / "scripts" / name for name in (
        "torch_profile_check.py", "cuda_kernel_ladder.py", "cuda_k1k2_times.py",
        "torch_slice_walls.py", "torch_gate_cost.py", "torch_overlap_walls.py",
        "torch_resilient_run.py", "torch_run_product.py", "torch_run_5broker_bounded.py")]
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, (f, bad)


def test_check_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check(kip320.make_model(Config(2, 2, 1, 1)))


def test_simulate_and_cli_simulate_run_on_the_card_by_default(monkeypatch, capsys):
    from kafka_specification_tpu_torch import cli
    from kafka_specification_tpu_torch.engine.simulate import simulate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate(kip320.make_model(Config(2, 2, 1, 1)), num_walks=1)
    assert cli.main(["simulate", str(REPO / "configs" / "IdSequence.cfg")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.nvcc_path()


def test_the_oracle_and_the_ast_checker_are_stdlib_only():
    """The reference interpreter shares no code with the kernel path (no
    torch, no packing, no kernels), and the static analysis' AST half
    needs no card stack: both import the standard library only (and the
    checker its own package's Finding)."""
    pkg = REPO / "kafka_specification_tpu_torch"
    assert set(_imported_roots(pkg / "oracle" / "interp.py")) <= {
        "__future__", "dataclasses", "typing"}
    tree = ast.parse((pkg / "oracle" / "interp.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    assert set(_imported_roots(pkg / "analysis" / "ownership.py")) <= {
        "__future__", "ast", "os", "re", "threading", "typing"}
    assert set(_imported_roots(pkg / "pipeline_registry.py")) <= {"__future__", "os"}


def test_the_supervisor_and_the_clock_import_no_torch():
    """The supervisor's parent must never hold a CUDA context: the clock is
    stdlib only, the retry ladder looks torch up only once it is loaded,
    and a fresh interpreter that imports the supervisor (or the standalone
    runner) has no torch in sys.modules."""
    pkg = REPO / "kafka_specification_tpu_torch"
    assert set(_imported_roots(pkg / "utils" / "clock.py")) <= {"__future__", "time"}
    assert "torch" not in set(_imported_roots(pkg / "resilience" / "retry.py"))
    assert "torch" not in set(_imported_roots(pkg / "resilience" / "supervisor.py"))
    code = textwrap.dedent(
        """
        import runpy, sys
        import kafka_specification_tpu_torch.resilience.supervisor
        import kafka_specification_tpu_torch.resilience.retry
        runpy.run_path("scripts/torch_resilient_run.py", run_name="not_main")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "jaxlib", "kafka_specification_tpu"))
        assert not bad, bad
        print("clean")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_the_service_client_path_imports_no_torch():
    """`cli submit/status/result` never pay the torch import: a fresh
    interpreter that imports the CLI and the torch-free half of service/
    (the queue, the verdict, the scheduler, the model cache's keys, the
    state-space cache) and the fleet-trace emitters has no torch, and
    nothing of JAX, in sys.modules."""
    code = textwrap.dedent(
        """
        import sys
        import kafka_specification_tpu_torch.cli
        import kafka_specification_tpu_torch.obs.fleettrace
        import kafka_specification_tpu_torch.service
        import kafka_specification_tpu_torch.service.kernel_cache
        import kafka_specification_tpu_torch.service.scheduler
        import kafka_specification_tpu_torch.service.state_cache
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "jaxlib", "kafka_specification_tpu"))
        assert not bad, bad
        print("clean")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_the_fleet_router_and_sweep_client_paths_import_no_torch(tmp_path):
    """The fleet parent, the router, the client verbs through a router,
    `trace`/`top`/`fleet-report`, and the sweep's report and bisect run
    on boxes that never pay the torch import: a fresh interpreter drives
    them all and ends with no torch, and nothing of JAX, in sys.modules.
    Only the sweep's vacuity pass imports torch (and initialises no CUDA:
    tests/test_torch_sweep.py)."""
    code = textwrap.dedent(
        f"""
        import contextlib, io, json, os, sys
        from kafka_specification_tpu_torch import cli
        from kafka_specification_tpu_torch.service.fleet import FleetManager, FleetServeConfig
        from kafka_specification_tpu_torch.service.queue import JobQueue
        from kafka_specification_tpu_torch.service.router import Router
        from kafka_specification_tpu_torch.sweep import bisect, cost, lattice, portfolio
        root = {str(tmp_path)!r}
        hosts = [os.path.join(root, "h0"), os.path.join(root, "h1")]
        for h in hosts:
            JobQueue(h)
        FleetManager(FleetServeConfig(service_dir=hosts[0], daemons=2))
        man = {{"schema": "kspec-sweep/1", "sweep_id": "s", "name": "s",
                "lattice": {{"sheets": [{{"axes": [
                    {{"name": "N", "kind": "constant", "values": [1, 2]}}]}}]}},
                "points": {{"p2": {{"point_id": "p2", "coords": [["N", 2]],
                                    "status": "done", "verdict": {{
                                        "violation": {{"invariant": "I", "depth": 1,
                                                       "trace_len": 2}},
                                        "distinct_states": 3, "exit_code": 1}}}}}}}}
        os.makedirs(os.path.join(root, "sw"))
        with open(os.path.join(root, "sw", "sweep.json"), "w") as fh:
            json.dump(man, fh)
        rt = os.path.join(root, "rt")
        calls = [["route", rt, "--hosts", *hosts, "--status"],
                 ["submit", "configs/IdSequence.cfg", "--router", rt],
                 ["status", "--router", rt], ["route", rt, "--once"],
                 ["top", "--once", "--router", rt], ["fleet-report", "--router", rt],
                 ["report", rt], ["sweep", "report", os.path.join(root, "sw")],
                 ["sweep", "bisect", os.path.join(root, "sw")],
                 ["report", os.path.join(root, "sw")]]
        rcs = []
        for args in calls:
            with contextlib.redirect_stdout(io.StringIO()), \\
                    contextlib.redirect_stderr(io.StringIO()):
                rcs.append(cli.main(args))
        assert rcs == [0] * len(calls), rcs
        job = Router(rt).submit(open("configs/IdSequence.cfg").read(), "IdSequence")["job_id"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["trace", job, "--router", rt]) == 0
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "jaxlib", "kafka_specification_tpu"))
        assert not bad, bad
        print("clean")
        """
    )
    env = {**os.environ}
    env.pop("KSPEC_FAULT", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_the_harness_verbs_import_no_torch(tmp_path):
    """`cli crashcheck`, `cli simfleet run` and `cli faults --list` (text
    and --json) run in a fresh interpreter that ends with no torch, and
    nothing of JAX, in sys.modules: the harnesses drive the torch-free
    control plane only."""
    code = textwrap.dedent(
        f"""
        import contextlib, io, json, sys
        from kafka_specification_tpu_torch import cli
        outs = []
        for args in (["crashcheck", "--json"],
                     ["simfleet", "run", "--seeds", "3", "--json",
                      "--out", {str(tmp_path / "repros")!r}],
                     ["faults", "--list"], ["faults", "--json"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                assert cli.main(args) == 0, args
            outs.append(buf.getvalue())
        assert json.loads(outs[0])["states"] == 254 and json.loads(outs[1])["clean"] == 3
        assert "Crashcheck scenarios" in outs[2]
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "jaxlib", "kafka_specification_tpu"))
        assert not bad, bad
        print("clean")
        """
    )
    env = {**os.environ}
    env.pop("KSPEC_FAULT", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
