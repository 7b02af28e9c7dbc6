"""PyTorch port: the plain versions of kernel K4's six rungs equal the TPU
ladder's Pallas bodies (``scripts/tpu_mosaic_ladder.py``, run through
``pl.pallas_call(interpret=True)``), bit for bit, on edge inputs.

The rung bodies are taken out of the script's ``main`` with ``ast`` and
executed with ``jax``, ``jnp`` and ``pl``: nothing is copied, and the script
writes nothing because its ``main`` never runs.
"""

import ast
import ctypes
import functools
import importlib.util
import json
import shutil
import subprocess
import textwrap
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
LADDER_CU = REPO / "kafka_specification_tpu_torch" / "ops" / "csrc" / "ladder.cu"


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


def _with_first(x0, n=256):
    x = _random(n, 9)
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
    # sizes the card's kernels split into 16-byte vectors and a tail
    "n3_x0_2_all_tail": lambda: _with_first(2, 3),
    "n7_x0_6_pos_in_tail": lambda: _with_first(6, 7),
    "n9_x0_6_pos_in_last_vector": lambda: _with_first(6, 9),
    "random1027": lambda: _random(1027, 5),
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


# --- ladder.cu itself, run on the CPU ---------------------------------
#
# The kernels' source compiled by g++ against a stub of the few CUDA
# runtime names it uses: cudaLaunchKernel runs every block and every
# thread of the grid in turn.

STUB_RUNTIME = textwrap.dedent("""
    #pragma once
    #include <cstddef>
    #include <cstdint>
    #define __global__
    #define __device__
    #define __forceinline__ inline
    #define __launch_bounds__(x)
    struct uint4 { unsigned x, y, z, w; };
    struct dim3 {
      unsigned x, y, z;
      dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
    };
    static dim3 blockIdx, threadIdx, gridDim, blockDim;
    typedef int cudaError_t;
    typedef void* cudaStream_t;
    enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
    static cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
    static cudaError_t cudaSetDevice(int) { return 0; }
    static const char* cudaGetErrorString(cudaError_t) { return "stub"; }
    static cudaError_t cudaLaunchKernel(const void* f, dim3 g, dim3 b, void** args, size_t,
                                        cudaStream_t) {
      auto k = (void (*)(const uint32_t*, uint32_t*, long long))f;
      gridDim = g;
      blockDim = b;
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned tx = 0; tx < b.x; ++tx) {
          blockIdx = dim3(bx);
          threadIdx = dim3(tx);
          k(*(const uint32_t**)args[0], *(uint32_t**)args[1], *(long long*)args[2]);
        }
      return 0;
    }
""")


@pytest.fixture(scope="module")
def ladder_on_cpu(tmp_path_factory):
    """kspec_ladder of ladder.cu, compiled for the CPU against the stub."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile ladder.cu for the CPU")
    d = tmp_path_factory.mktemp("ladder_cpu")
    (d / "cuda_runtime.h").write_text(STUB_RUNTIME)
    lib = d / "libladder_cpu.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}", "-x", "c++",
                    "-Wno-unknown-pragmas", "-o", str(lib), str(LADDER_CU)],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).kspec_ladder
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


# all tail, pos in the tail, pos in the last vector, a tail after one and
# after many blocks (a block takes 1,024 elements)
LADDER_SIZES = [(1, 0), (3, 2), (6, 5), (7, 6), (9, 6), (1027, 13), (16389, 6), (40003, 4)]


@pytest.mark.parametrize("n, x0", LADDER_SIZES)
@pytest.mark.parametrize("aligned", [True, False], ids=["16-byte", "4-byte"])
@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_ladder_cu_on_the_cpu_equals_plain(ladder_on_cpu, rung, aligned, n, x0):
    """Every thread's share (its vector or its four scalars, the tail, the
    lane that holds pos) gives the plain version's bits, and nothing is
    written past n."""
    rng = np.random.default_rng(n)
    buf = rng.integers(0, 2**32, size=n + 8, dtype=np.uint32)
    start = 0 if buf.ctypes.data % 16 == 0 else (16 - buf.ctypes.data % 16) // 4
    x = buf[start + (0 if aligned else 1):][:n]
    x[0] = x0
    out = np.full(n + 4, 0xDEADBEEF, dtype=np.uint32)
    assert (x.ctypes.data % 16 == 0) == aligned and out.ctypes.data % 16 == 0
    assert ladder_on_cpu(cuda_ladder.RUNGS.index(rung), x.ctypes.data, out.ctypes.data,
                         n, 1, 0, None) == 0
    want = cuda_ladder.PLAIN[rung](torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out[:n].astype(np.int64), want)
    assert (out[n:] == 0xDEADBEEF).all()
