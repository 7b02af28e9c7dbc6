"""PyTorch port of AsyncIsr at 4 replicas, the widest the encoding admits
(2^4 ISR subsets; 16-bit request sets), against the JAX package with zero
tolerance: 4r M2 V2 (165,312 states, diameter 21, 3 lanes) through
check() on the device, device-hash and host backends with the fused and
legacy pipelines (levels, total, diameter, the per-level stats lines and
the digest chain), and every action's cells on a sample of the states JAX
reached."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu_torch import check, interop

from test_torch_async_isr import BACKENDS, PIPELINES, chain_of, pair, stats_lines
from torch_guards import overlap_guard  # noqa: F401  (autouse)

CFG = (4, 2, 2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax4r")
    jm, _ = pair(*CFG)
    levels = []
    res = jbfs.check(jm, checkpoint_dir=str(d / "ck"), checkpoint_keep=1,
                     stats_path=str(d / "stats.jsonl"), visited_backend="host",
                     min_bucket=4096, chunk_size=4096,
                     collect_levels=levels)
    rows = np.concatenate([np.asarray(x) for x in levels])
    return res, chain_of(d / "ck"), stats_lines(d / "stats.jsonl"), rows


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_check_4r_equals_jax(jax_run, backend, pipeline, tmp_path):
    jr, jchain, jstats, _ = jax_run
    jm, tm = pair(*CFG)
    assert tm.spec.num_lanes == jm.spec.num_lanes == 3
    tr = check(tm, device="cpu", visited_backend=backend, pipeline=pipeline,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_keep=1,
               stats_path=str(tmp_path / "stats.jsonl"))
    assert (tr.total, tr.diameter) == (165312, 21)
    assert (tr.levels, tr.total, tr.diameter, tr.ok) == (jr.levels, jr.total, jr.diameter, True)
    np.testing.assert_array_equal(chain_of(tmp_path / "ck"), jchain)
    assert stats_lines(tmp_path / "stats.jsonl") == jstats


def test_action_kernels_4r_match_jax(jax_run):
    rows = jax_run[3][::40]
    jm, tm = pair(*CFG)
    jstates = jax.vmap(jm.spec.unpack)(jnp.asarray(rows))
    tstates = tm.spec.unpack(interop.from_u32(rows, "cpu"))
    for ja, ta in zip(jm.actions, tm.actions):
        @jax.jit
        def expand(s, a=ja):
            en, nxt = jax.vmap(
                lambda st: jax.vmap(lambda c: a.kernel(st, c))(jnp.arange(a.n_choices))
            )(s)
            return en, jax.vmap(jax.vmap(jm.spec.pack))(nxt)

        j_en, j_packed = map(np.asarray, expand(jstates))
        t_en, t_nxt = ta.kernel(tstates)
        assert j_en.any(), ja.name
        np.testing.assert_array_equal(t_en.numpy(), j_en, err_msg=ja.name)
        np.testing.assert_array_equal(interop.to_u32(tm.spec.pack(t_nxt)), j_packed, err_msg=ja.name)
