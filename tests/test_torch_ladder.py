"""PyTorch port: the plain versions of kernel K4's six rungs equal the TPU
ladder's Pallas bodies (``scripts/tpu_mosaic_ladder.py``, run through
``pl.pallas_call(interpret=True)``), bit for bit, on edge inputs.

The rung bodies are taken out of the script's ``main`` with ``ast`` and
executed with ``jax``, ``jnp`` and ``pl``: nothing is copied, and the script
writes nothing because its ``main`` never runs.
"""

import ast
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from kafka_specification_tpu_torch.ops import cuda_ladder

REPO = Path(__file__).resolve().parents[1]
TPU_LADDER = REPO / "scripts" / "tpu_mosaic_ladder.py"


@functools.cache
def jax_rungs():
    """{rung: Pallas body} from the nested `def k_*` of the script's main."""
    tree = ast.parse(TPU_LADDER.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name.startswith("k_")]
    ns = {"jax": jax, "jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(TPU_LADDER), "exec"), ns)
    return {d.name[2:]: ns[d.name] for d in defs}


@functools.cache
def jax_call(rung, n):
    body = jax_rungs()[rung]
    return jax.jit(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((n,), jnp.uint32), interpret=True
    ))


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


def _with_first(x0):
    x = _random(256, 9)
    x[0] = x0
    return x


INPUTS = {
    "arange256": lambda: np.arange(256, dtype=np.uint32),
    "random7": lambda: _random(7, 1),
    "random256": lambda: _random(256, 2),
    "random1000": lambda: _random(1000, 3),
    "clamp_n4_x0_6": lambda: np.concatenate([[6], _random(3, 4)]).astype(np.uint32),
    "x0_0": lambda: _with_first(0),
    "x0_6": lambda: _with_first(6),
    "x0_top_bit": lambda: _with_first(0x80000000),
    "x0_all_ones": lambda: _with_first(0xFFFFFFFF),
    "all_ones": lambda: np.full(256, 0xFFFFFFFF, dtype=np.uint32),
}


def test_the_script_has_the_six_rungs_in_order():
    assert tuple(jax_rungs()) == cuda_ladder.RUNGS
    for rung, where in cuda_ladder.REPLACES.items():
        line = int(where.rsplit(":", 1)[1])
        assert f"def k_{rung}(" in TPU_LADDER.read_text().splitlines()[line - 1]


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_plain_rung_equals_pallas_body(rung, inp):
    x = INPUTS[inp]()
    want = np.asarray(jax_call(rung, x.shape[0])(jnp.asarray(x)))
    got = cuda_ladder.run(rung, torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("inp", ["arange256", "x0_all_ones", "all_ones"])
@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_library_call_has_the_plain_versions_bits(rung, inp):
    x = torch.from_numpy(INPUTS[inp]().astype(np.int64))
    fn = cuda_ladder.library_call(rung, cuda_ladder.to_i32(x))
    if rung in ("dyn_read", "dyn_slice"):
        assert fn is None  # pos comes from the data: no one call computes it
    else:
        assert torch.equal(cuda_ladder.from_i32(fn()), cuda_ladder.PLAIN[rung](x))


def test_edge_values_clamp_unsigned_remainder_and_wrap():
    # the clamp: n = 4 and x[0] = 6 reads and bumps x[3]
    x = torch.tensor([6, 10, 20, 30], dtype=torch.int64)
    assert cuda_ladder.run("dyn_read", x).tolist() == [36, 40, 50, 60]
    assert cuda_ladder.run("dyn_slice", x).tolist() == [6, 10, 20, 31]
    # an unsigned remainder: 2^31 % 7 = 2, (2^32 - 1) % 7 = 3
    top = torch.tensor([0x80000000, 0, 0, 5, 0], dtype=torch.int64)
    assert cuda_ladder.run("dyn_slice", top).tolist() == [0x80000000, 0, 1, 5, 0]
    ones = torch.tensor([0xFFFFFFFF, 0, 0, 7, 0], dtype=torch.int64)
    assert cuda_ladder.run("dyn_read", ones).tolist() == [6, 7, 7, 14, 7]
    # wrap at 2^32
    assert cuda_ladder.run("vec", ones[:1]).tolist() == [4]
    assert cuda_ladder.run("scalar_loop", ones[:1]).tolist() == [0]


def test_launch_refuses_a_cpu_tensor_and_run_bad_input():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ladder.launch("vec", torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown rung"):
        cuda_ladder.run("dyn_write", torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="n >= 1"):
        cuda_ladder.run("vec", torch.zeros(0, dtype=torch.int64))


def test_run_ladder_on_the_cpu_gives_six_records_without_kernel_fields():
    seen = []
    recs = cuda_ladder.run_ladder(device="cpu", emit=seen.append)
    assert [r["rung"] for r in recs] == list(cuda_ladder.RUNGS) and seen == recs
    for r in recs:
        assert r["ok"] and r["error"] is None
        for key in ("max_abs_err", "ms", "plain_ms", "library_ms", "launches"):
            assert r[key] is None
        # 2 KB at 3.35 TB/s
        assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(2048 / 3.35e12 * 1e3)


def test_run_ladder_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_ladder.run_ladder()


def _script():
    spec = importlib.util.spec_from_file_location(
        "cuda_kernel_ladder", REPO / "scripts" / "cuda_kernel_ladder.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ladder_script_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "ladder.json"
    assert _script().main(["--device", "cpu", "--n", "64", "--out", str(out)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["rung"] for d in lines] == list(cuda_ladder.RUNGS)
    assert all(d["platform"] == "cpu" and d["n"] == 64 and d["ok"] for d in lines)
    banked = json.loads(out.read_text())
    assert list(banked["rungs"]) == list(cuda_ladder.RUNGS)


def test_ladder_script_exits_3_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _script().main([]) == 3
