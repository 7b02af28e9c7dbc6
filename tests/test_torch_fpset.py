"""PyTorch port: the host fingerprint set (native/), its plain version and
the JAX package's FpSet agree on insert, insert_compact, contains and dump,
on random 64-bit fingerprints with in-batch duplicates, 0 and the top
bit; the library is built into build/native/; and without g++ the set,
check(visited_backend="host") and `cli check --visited-backend host` fail
loudly, with no fallback."""

from pathlib import Path

import numpy as np
import pytest

from kafka_specification_tpu.native import FpSet as JFpSet
from kafka_specification_tpu_torch import check, cli, native
from kafka_specification_tpu_torch.models import id_sequence as tids
from torch_guards import overlap_guard  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _runs_root(tmp_path, monkeypatch):
    """Each CLI check's run directory lands under this test's tmp_path."""
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))


REPO = Path(__file__).resolve().parents[1]
EDGES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def batches(seed, n_batches=6, size=3000):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([rng.integers(0, 2**64, size=4 * size, dtype=np.uint64), EDGES])
    for _ in range(n_batches):
        yield rng.choice(pool, size=size)  # duplicates within and across batches


def test_native_plain_and_jax_agree():
    sets = {"native": native.FpSet(64), "plain": native.PlainFpSet(64), "jax": JFpSet(64)}
    assert JFpSet(64).native  # the reference runs its own C++ too
    for batch in batches(0):
        masks = {k: s.insert(batch) for k, s in sets.items()}
        assert masks["native"].dtype == bool
        np.testing.assert_array_equal(masks["native"], masks["jax"])
        np.testing.assert_array_equal(masks["plain"], masks["jax"])
        probe = np.concatenate([batch[:500], np.arange(500, dtype=np.uint64) * 7919])
        found = {k: s.contains(probe) for k, s in sets.items()}
        np.testing.assert_array_equal(found["native"], found["jax"])
        np.testing.assert_array_equal(found["plain"], found["jax"])
        assert len(sets["native"]) == len(sets["plain"]) == len(sets["jax"])
    # one code, one insertion order: the dumps agree slot for slot
    np.testing.assert_array_equal(sets["native"].dump(), sets["jax"].dump())
    np.testing.assert_array_equal(np.sort(sets["plain"].dump()), np.sort(sets["jax"].dump()))
    assert sets["native"].dump().dtype == np.uint64


def test_insert_compact_agrees():
    rng = np.random.default_rng(2)
    k = 3
    sets = {"native": native.FpSet(), "plain": native.PlainFpSet(), "jax": JFpSet()}
    arenas = {name: (np.zeros((20000, k), np.uint32), np.zeros(20000, np.int64),
                     np.zeros(20000, np.int32)) for name in sets}
    written = dict.fromkeys(sets, 0)
    for base, batch in enumerate(batches(3, size=2000)):
        hi = (batch >> np.uint64(32)).astype(np.uint32)
        lo = batch.astype(np.uint32)
        rows = rng.integers(0, 2**32, size=(len(batch), k), dtype=np.uint32)
        parent = rng.integers(0, 1000, size=len(batch)).astype(np.int32)
        act = rng.integers(0, 9, size=len(batch)).astype(np.int32)
        got = {}
        for name, s in sets.items():
            a_rows, a_par, a_act = arenas[name]
            w0 = written[name]
            got[name] = s.insert_compact(hi, lo, rows, parent, 100 * base, act,
                                         a_rows[w0:], a_par[w0:], a_act[w0:])
            written[name] += got[name]
        assert got["native"] == got["plain"] == got["jax"]
    for name in ("native", "plain"):
        for mine, ref in zip(arenas[name], arenas["jax"]):
            np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(sets["native"].dump(), sets["jax"].dump())


def test_arguments_are_checked_before_the_c_pass():
    s = native.FpSet()
    hi = lo = np.zeros(4, np.uint32)
    rows = np.zeros((4, 2), np.uint32)
    par = act = np.zeros(4, np.int32)
    small = (np.zeros((3, 2), np.uint32), np.zeros(3, np.int64), np.zeros(3, np.int32))
    for bad in (native.FpSet(), native.PlainFpSet()):
        with pytest.raises(ValueError, match="no room"):
            bad.insert_compact(hi, lo, rows, par, 0, act, *small)
        with pytest.raises(ValueError, match="rows of hi"):
            bad.insert_compact(hi, lo[:3], rows, par, 0, act,
                               np.zeros((4, 2), np.uint32), np.zeros(4, np.int64),
                               np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="C-contiguous"):
        s.insert_compact(hi, lo, rows, par, 0, act, np.zeros((4, 2), np.uint32),
                         np.zeros(4, np.int32), np.zeros(4, np.int32))


def test_built_into_build_native_named_by_source():
    native.library()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libfpset-") and path.suffix == ".so"


@pytest.fixture
def no_gxx(monkeypatch, tmp_path):
    """No library built yet, and no g++ on the PATH."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))


def test_missing_gxx_raises_with_no_fallback(no_gxx, capsys):
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        native.FpSet()
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        check(tids.make_model(3), device="cpu", visited_backend="host")
    # the other backends need no toolchain
    assert check(tids.make_model(3), device="cpu").total == 5
    rc = cli.main(["check", str(REPO / "configs" / "IdSequence.cfg"), "--cpu",
                   "--visited-backend", "host"])
    assert rc == 2 and "g++ not found" in capsys.readouterr().err


def test_gxx_refusing_the_source_raises(monkeypatch, tmp_path):
    bad = tmp_path / "fpset.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.library()
    assert not list((tmp_path / "build").glob("*"))  # no half-built library left
