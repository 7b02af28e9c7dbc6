"""PyTorch port: it imports no JAX and nothing of the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
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

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "kafka_specification_tpu")


def test_import_and_tiny_check_load_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import kafka_specification_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from kafka_specification_tpu_torch import build_model, check, load_config
        cfg = load_config("configs/Kip101.cfg")
        cfg.constants.update(MaxRecords=1, MaxLeaderEpoch=1)
        cfg.invariants = ["TypeOk"]
        res = check(build_model("Kip101", cfg), device="cpu")
        assert res.ok and res.total == 341, res
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "kafka_specification_tpu")
        )
        assert not bad, bad
        print("clean")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
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
    files.append(REPO / "chip_smoke.py")
    # the port's scripts
    files += [REPO / "scripts" / name for name in (
        "torch_profile_check.py", "cuda_kernel_ladder.py", "cuda_k1k2_times.py")]
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, (f, bad)


def test_check_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check(kip320.make_model(Config(2, 2, 1, 1)))


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.nvcc_path()
