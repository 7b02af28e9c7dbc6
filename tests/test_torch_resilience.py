"""PyTorch port: the chunk failure ladder (resilience/retry.py), the two
chunk faults (``transient_device_err``, ``compile_oom``), the allocation
failure degrades and sampled shadow re-execution, against the JAX package's
with zero tolerance.

Held unit for unit: ``classify`` on JAX's strings (and the port's own
rule for CUDA failures: ``torch.OutOfMemoryError`` is ``device_resource``,
a CUDA runtime error ``other``), ``RetryPolicy.delay`` under one seeded
``random.Random``, ``ChunkRetryHandler.handle``'s actions, counters,
records and stderr lines for the same sequences of exceptions,
``FaultPlan.chunk_error``, ``sample_chunk`` and ``shadow_rate``.  Held run
against run: the injected faults through ``check()`` on FRL(2,2,2) (JAX's
test model) over the three backends with the overlap layer on and off, on
``pipeline="device"``, and ``compile_oom`` at JAX's
``tests/test_pipeline.py`` model and knobs; the shadow's count and spans.
The allocation failures are raised by a wrapper on the CPU (a real one
needs the card: ``chip_smoke.py`` phase ``resilience``): a chunk's
dispatch splits in two and halves the chunk size, a device level falls
back to the per-chunk path, and neither changes the result.  Retries
sleep ``KSPEC_RETRY_BASE_DELAY=0.001`` (JAX's fast-retry fixture)."""

import os
import random

import numpy as np
import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.obs import metrics as jmet
from kafka_specification_tpu.obs import runctx as jrunctx
from kafka_specification_tpu.obs import tracer as jtracer
from kafka_specification_tpu.resilience import faults as jfaults
from kafka_specification_tpu.resilience import integrity as jinteg
from kafka_specification_tpu.resilience import retry as jretry
from kafka_specification_tpu.utils.cli import main as jcli
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch import cli as tcli
from kafka_specification_tpu_torch.engine import bfs as tbfs
from kafka_specification_tpu_torch.engine import pipeline as tpipeline
from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.obs import metrics as tmet
from kafka_specification_tpu_torch.obs import runctx as trunctx
from kafka_specification_tpu_torch.obs import tracer as ttracer
from kafka_specification_tpu_torch.resilience import checkpoints as tckpt
from kafka_specification_tpu_torch.resilience import faults as tfaults
from kafka_specification_tpu_torch.resilience import integrity as tinteg
from kafka_specification_tpu_torch.resilience import retry as tretry
from kafka_specification_tpu_torch.resilience.integrity import IntegrityError
from torch_guards import overlap_guard  # noqa: F401  (autouse)

THW = "KafkaTruncateToHighWatermark"
# JAX's tests/test_pipeline.py knobs (its KW, without the stats file)
PIPE_KW = dict(min_bucket=32, chunk_size=256, compact_gate=32, store_trace=True)
# small chunks over THW 2r (levels up to 60 rows): a halved chunk size shows
SPLIT_KW = dict(min_bucket=8, chunk_size=64)
BACKENDS = ("device", "device-hash", "host")
STAT_KEYS = ("pipeline_fallback", "adaptive_compile_fallback", "transient_retries",
             "degradations")
OOM_TEXT = "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB total capacity)"


@pytest.fixture(autouse=True)
def _fast_retries_no_leaks(tmp_path, monkeypatch):
    """JAX's fast-retry fixture; every run directory under tmp_path; no
    fault plan, retry knob, tracer or registry left behind."""
    monkeypatch.setenv("KSPEC_RETRY_BASE_DELAY", "0.001")
    for var in ("KSPEC_FAULT", "KSPEC_RETRY_MAX", "KSPEC_RETRY_MAX_DELAY",
                "KSPEC_INTEGRITY_SHADOW", "KSPEC_PIPELINE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    yield
    monkeypatch.undo()
    left = [v for v in ("KSPEC_FAULT", "KSPEC_RETRY_MAX", "KSPEC_INTEGRITY_SHADOW")
            if v in os.environ]
    for mod in (jtracer, ttracer):
        mod.set_tracer(None)
    for mod in (jmet, tmet):
        mod.set_registry(None)
    assert not left, f"left set: {left}"


_MODELS: dict = {}


def models(name):
    if name not in _MODELS:
        if name == "FRL":
            _MODELS[name] = (jfrl.make_model(2, 2, 2), tfrl.make_model(2, 2, 2))
        elif name == "FRL-hashed":
            _MODELS[name] = (None, tfrl.make_model(2, 2, 2, force_hashed=True))
        else:
            inv = ("TypeOk", "WeakIsr")
            _MODELS[name] = (jvariants.make_model(name, JConfig(2, 2, 1, 1), inv),
                             tvariants.make_model(name, Config(2, 2, 1, 1), inv))
    return _MODELS[name]


def outcome(res):
    return (res.total, res.diameter, tuple(res.levels),
            (res.violation.invariant, res.violation.depth) if res.violation else None)


def ladder_stats(res):
    return {k: res.stats[k] for k in STAT_KEYS}


def chain_of(ckpt_dir):
    return tckpt.verify_file(os.path.join(ckpt_dir, CHECKPOINT_BASENAME))["digest_chain"]


_JAX: dict = {}


def jax_run(key, fault, name, **kw):
    """The JAX package's check() under `fault`, once per key."""
    if key not in _JAX:
        if fault:
            os.environ["KSPEC_FAULT"] = fault
        try:
            _JAX[key] = jbfs.check(models(name)[0], **kw)
        finally:
            os.environ.pop("KSPEC_FAULT", None)
    return _JAX[key]


# --- the ladder, unit for unit ------------------------------------------------

JAX_STRINGS = [
    "UNAVAILABLE: socket closed", "DEADLINE_EXCEEDED: rpc", "DATA_LOSS: torn", "ABORTED",
    "CANCELLED: x", "Socket closed", "connection reset by peer", "LLVM ERROR: out of memory",
    "std::bad_alloc", "host out of memory", "RESOURCE_EXHAUSTED: Out of memory allocating 8 bytes",
    "shape mismatch", "", jfaults.TRANSIENT_MARKER, jfaults.OOM_MARKER,
]


@pytest.mark.parametrize("text", JAX_STRINGS)
def test_classify_equals_jax_on_its_strings(text):
    for exc in (RuntimeError(text), ValueError(text), OSError(text)):
        assert tretry.classify(exc) == jretry.classify(exc)


def test_classify_cuda_failures_by_class():
    oom = torch.OutOfMemoryError(OOM_TEXT)
    assert torch.cuda.OutOfMemoryError is torch.OutOfMemoryError
    assert tretry.classify(oom) == "device_resource"
    # the substring rules alone would call it a compile OOM
    assert jretry.classify(oom) == "compile_oom"
    for text in ("CUDA error: an illegal memory access was encountered",
                 "CUDA error: unspecified launch failure"):
        assert tretry.classify(RuntimeError(text)) == "other"
        assert tretry.is_sticky_cuda_error(RuntimeError(text))
        if hasattr(torch, "AcceleratorError"):
            assert tretry.classify(torch.AcceleratorError(text)) == "other"
    # "CUDA error:" must lead: a transient text that mentions it stays transient
    assert tretry.classify(RuntimeError("UNAVAILABLE: after CUDA error: x")) == "transient"
    assert not tretry.is_sticky_cuda_error(oom)


def test_retry_policy_equals_jax(monkeypatch):
    for env in ({}, {"KSPEC_RETRY_MAX": "5", "KSPEC_RETRY_BASE_DELAY": "0.25",
                     "KSPEC_RETRY_MAX_DELAY": "2"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t, j = tretry.RetryPolicy.from_env(), jretry.RetryPolicy.from_env()
        assert (t.max_retries, t.base_delay, t.factor, t.max_delay, t.jitter) == (
            j.max_retries, j.base_delay, j.factor, j.max_delay, j.jitter)
        t.rng, j.rng = random.Random(7), random.Random(7)
        assert [t.delay(i) for i in range(1, 12)] == [j.delay(i) for i in range(1, 12)]


T, R, O, X = (jfaults.TRANSIENT_MARKER, "RESOURCE_EXHAUSTED: out of device memory",
              jfaults.OOM_MARKER, "shape mismatch")
# (policy max_retries, [(text, escalated, retry_transient, reset before)])
SEQUENCES = {
    "transient budget": (3, [(T, False, True, False)] * 4),
    "transient escalated": (2, [(T, True, True, False)] * 3),
    "transient reset per chunk": (1, [(T, False, True, True)] * 3 + [(T, False, True, False)]),
    "degrade wall": (0, [(R, False, True, False)] * 7),
    "resource escalated": (0, [(R, True, True, False)] * 2),
    "lockstep": (3, [(T, False, False, False), (R, False, False, False),
                     (R, True, False, False)]),
    "compile oom": (3, [(O, True, True, False), (O, False, True, False)]),
    "other": (3, [(X, True, True, False), (X, False, True, False)]),
    "mixed": (2, [(T, False, True, False), (R, False, True, False), (T, True, True, False),
                  (O, True, True, True), (T, False, True, False), (T, False, True, False)]),
}


def drive(mod, max_retries, seq):
    h = mod.ChunkRetryHandler(policy=mod.RetryPolicy(max_retries=max_retries, base_delay=0.0,
                                                     rng=random.Random(3)), tag="[engine]")
    acts = []
    for text, esc, retry_transient, reset in seq:
        if reset:
            h.reset_chunk()
        try:
            acts.append(h.handle(RuntimeError(text), escalated=esc, depth=4,
                                 retry_transient=retry_transient))
        except RuntimeError as e:
            acts.append(f"raise {e}")
    return acts, h.retries_total, h.chunk_degrades, h.transient_try, h.degradations


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_handler_equals_jax(name, capsys):
    max_retries, seq = SEQUENCES[name]
    t = drive(tretry, max_retries, seq)
    t_err = capsys.readouterr().err
    j = drive(jretry, max_retries, seq)
    j_err = capsys.readouterr().err
    assert t == j
    assert t_err == j_err
    assert tretry.ChunkRetryHandler(policy=None, tag="").max_chunk_degrades == 6


def test_handler_on_cuda_failures(capsys):
    pol = tretry.RetryPolicy(max_retries=3, base_delay=0.0)
    h = tretry.ChunkRetryHandler(policy=pol, tag="[engine]")
    oom = torch.OutOfMemoryError(OOM_TEXT)
    assert h.handle(oom, escalated=False, depth=2) == "degrade_chunk"
    assert h.degradations == [{"kind": "chunk_degrade", "depth": 2,
                               "error": f"OutOfMemoryError: {OOM_TEXT}"}]
    assert h.handle(oom, escalated=True, depth=3) == "degrade"  # JAX's escalated rung
    assert h.degradations[-1]["kind"] == "compile_fallback"
    sticky = RuntimeError("CUDA error: an illegal memory access was encountered")
    for esc in (False, True):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            h.handle(sticky, escalated=esc, depth=3)
    assert (h.retries_total, h.chunk_degrades, len(h.degradations)) == (0, 1, 2)
    assert "device RESOURCE_EXHAUSTED executing a chunk (OutOfMemoryError)" in (
        capsys.readouterr().err)


def test_chunk_error_and_wired_sites_equal_jax():
    for spec in ("transient_device_err:2,compile_oom", "compile_oom,transient_device_err",
                 "compile_oom:2", "transient_device_err@shard0:2"):
        t, j = tfaults.FaultPlan(spec), jfaults.FaultPlan(spec)
        for esc in (False, True, False, True, True, True):
            te, je = t.chunk_error(esc), j.chunk_error(esc)
            assert (type(te), str(te)) == (type(je), str(je))
    assert (tfaults.TRANSIENT_MARKER, tfaults.OOM_MARKER) == (
        jfaults.TRANSIENT_MARKER, jfaults.OOM_MARKER)
    assert tfaults.FaultPlan("compile_oom,transient_device_err:2").unwired() == []
    assert tretry.classify(RuntimeError(tfaults.TRANSIENT_MARKER)) == "transient"
    assert tretry.classify(RuntimeError(tfaults.OOM_MARKER)) == "compile_oom"


# --- the two faults through check() ---------------------------------------------


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_transient_retries_equal_jax(backend, overlap, monkeypatch):
    j = jax_run(("transient", backend), "transient_device_err:2", "FRL", min_bucket=32,
                store_trace=False, visited_backend=backend)
    monkeypatch.setenv("KSPEC_FAULT", "transient_device_err:2")
    t = check(models("FRL")[1], min_bucket=32, store_trace=False, visited_backend=backend,
              overlap=overlap, device="cpu")
    assert outcome(t) == outcome(j) and t.total == 49
    assert ladder_stats(t) == ladder_stats(j)
    assert t.stats["transient_retries"] == 2


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_transient_budget_exhaustion_raises(backend, overlap, monkeypatch):
    monkeypatch.setenv("KSPEC_FAULT", "transient_device_err:50")
    monkeypatch.setenv("KSPEC_RETRY_MAX", "2")
    with pytest.raises(RuntimeError, match="injected transient"):
        check(models("FRL")[1], min_bucket=32, store_trace=False, visited_backend=backend,
              overlap=overlap, device="cpu")


@pytest.mark.parametrize("backend", ["device", "host"])
def test_transient_on_a_device_level_equals_jax(backend, monkeypatch):
    """On pipeline="device" the first attempt is a level: it is re-run."""
    kw = dict(PIPE_KW, pipeline="device", visited_backend=backend)
    j = jax_run(("transient-device", backend), "transient_device_err:2", THW, **kw)
    monkeypatch.setenv("KSPEC_FAULT", "transient_device_err:2")
    t = check(models(THW)[1], device="cpu", **kw)
    assert outcome(t) == outcome(j)
    assert ladder_stats(t) == ladder_stats(j) and t.stats["transient_retries"] == 2
    assert t.stats["device"] == j.stats["device"] and t.stats["device"]["levels"] > 0


@pytest.mark.parametrize("pipeline", ["fused", "device"])
def test_compile_oom_equals_jax(pipeline, monkeypatch):
    """JAX's tests/test_pipeline.py::test_injected_compile_oom_degrades_*
    at its model and knobs: fused degrades to legacy, device to fused."""
    kw = dict(PIPE_KW, pipeline=pipeline)
    j = jax_run(("compile_oom", pipeline), "compile_oom", THW, **kw)
    j_ref = jax_run(("clean", pipeline), None, THW, **kw)
    monkeypatch.setenv("KSPEC_FAULT", "compile_oom")
    t = check(models(THW)[1], device="cpu", **kw)
    assert outcome(t) == outcome(j) == outcome(j_ref)
    assert ladder_stats(t) == ladder_stats(j)
    assert [d["kind"] for d in t.stats["degradations"]] == ["compile_fallback"]
    if pipeline == "device":
        assert t.stats["device"] == j.stats["device"]
        assert t.stats["device"]["levels"] == 0
        assert "injected by KSPEC_FAULT=compile_oom" in t.stats["device"]["fallback"]
        assert t.stats["pipeline_fallback"] is False
    else:
        assert t.stats["pipeline_fallback"] is True


def test_compile_oom_on_legacy_leaves_the_run_untouched(monkeypatch):
    """The port's legacy never escalates (no AdaptiveCompact): the fault
    stays armed and nothing degrades."""
    kw = dict(PIPE_KW, pipeline="legacy")
    ref = check(models(THW)[1], device="cpu", **kw)
    monkeypatch.setenv("KSPEC_FAULT", "compile_oom")
    t = check(models(THW)[1], device="cpu", **kw)
    assert outcome(t) == outcome(ref)
    assert ladder_stats(t) == ladder_stats(ref) == {
        "pipeline_fallback": False, "adaptive_compile_fallback": False,
        "transient_retries": 0, "degradations": []}


# --- allocation failures, raised on the CPU by a wrapper ---------------------------


def failing(real, fail_on, exc_fn, seen):
    """`real` with the calls numbered in `fail_on` raising exc_fn(); the
    first argument's rows (a chunk's piece, or None) go to `seen`."""
    calls = [0]

    def wrapper(*a, **k):
        calls[0] += 1
        if calls[0] in fail_on:
            raise exc_fn()
        seen.append(a[1].shape[0] if len(a) > 1 and hasattr(a[1], "shape") else None)
        return real(*a, **k)

    return wrapper


def depth_of_chunks(seen, levels):
    """Chunk sizes dispatched per level (a level's frontier is the level
    found before it), from the wrapper's record."""
    out, i = [], 0
    for f in levels:
        got, rows = [], 0
        while rows < f and i < len(seen):
            got.append(seen[i])
            rows += seen[i]
            i += 1
        out.append(got)
    return out


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("pipeline", ["legacy", "fused"])
def test_allocation_failure_in_a_chunk_splits_it(pipeline, overlap, tmp_path, monkeypatch):
    """The 5th dispatch raises torch.OutOfMemoryError (below the compact
    gate: not escalated): one chunk_degrade record, the chunk re-dispatched
    as its two halves, the chunk size halved from the next level to the
    JAX floor (next_pow2(max(32, min_bucket))), and the same levels,
    total, chain and verdict depth as a clean run, no chunk committed
    twice."""
    model = models(THW)[1]
    kw = dict(SPLIT_KW, pipeline=pipeline, overlap=overlap, checkpoint_every=1)
    clean_seen, seen = [], []
    monkeypatch.setattr(tbfs, "run_chunk", failing(tpipeline.run_chunk, (), None, clean_seen))
    ref = check(model, device="cpu", checkpoint_dir=str(tmp_path / "ref"), **kw)
    monkeypatch.setattr(tbfs, "run_chunk", failing(
        tpipeline.run_chunk, (5,), lambda: torch.OutOfMemoryError(OOM_TEXT), seen))
    t = check(model, device="cpu", checkpoint_dir=str(tmp_path / "oom"), **kw)
    assert outcome(t) == outcome(ref) and t.violation.depth == 8
    assert np.array_equal(chain_of(tmp_path / "oom"), chain_of(tmp_path / "ref"))
    deg = t.stats["degradations"]
    assert [d["kind"] for d in deg] == ["chunk_degrade"]
    assert deg[0]["error"] == f"OutOfMemoryError: {OOM_TEXT}"
    assert t.stats["adaptive_compile_fallback"] is True
    assert t.stats["pipeline_fallback"] is False and t.stats["transient_retries"] == 0
    assert t.stats["overlap"]["staged_chunks_peak"] <= (2 if overlap else 0)
    # every row of every frontier expanded in full was dispatched exactly
    # once (the failed attempt never reached run_chunk), so no chunk was
    # committed twice (the verdict's level stops at its chunk)
    vd = t.violation.depth
    per_level = depth_of_chunks(seen, t.levels)
    assert [sum(c) for c in per_level[:vd]] == t.levels[:vd]
    chunk, floor = SPLIT_KW["chunk_size"], 32
    fail_at = 4  # the calls before the failing 5th
    assert seen[:fail_at] == clean_seen[:fail_at]
    failed = clean_seen[fail_at]
    assert seen[fail_at: fail_at + 2] == [(failed + 1) // 2, failed // 2]
    d = deg[0]["depth"]
    assert max(max(c) for c in per_level[:d + 1] if c) <= chunk
    later = [n for c in per_level[d + 1:] for n in c]
    assert later and max(later) <= max(floor, chunk >> 1)
    assert max(n for c in depth_of_chunks(clean_seen, ref.levels)[d + 1:] for n in c) > 32


def test_allocation_failures_stop_at_the_wall(monkeypatch):
    """Each failure halves the chunk again; the seventh surfaces (the
    handler's 6-degrade wall), never retried in place or swallowed."""
    seen = []
    monkeypatch.setattr(tbfs, "run_chunk", failing(
        tpipeline.run_chunk, range(1, 100), lambda: torch.OutOfMemoryError(OOM_TEXT), seen))
    with pytest.raises(torch.OutOfMemoryError):
        check(models(THW)[1], device="cpu", pipeline="legacy", **SPLIT_KW)
    assert seen == []


def test_escalated_allocation_failure_degrades_a_rung_first(monkeypatch):
    """A fused chunk above the gate is escalated: its first failure is
    JAX's compile_fallback (fused -> legacy), the second, on the legacy
    rung, the chunk_degrade."""
    seen, clean = [], []
    kw = dict(PIPE_KW, pipeline="fused")
    monkeypatch.setattr(tbfs, "run_chunk", failing(tpipeline.run_chunk, (), None, clean))
    ref = check(models(THW)[1], device="cpu", **kw)
    monkeypatch.setattr(tbfs, "run_chunk", failing(
        tpipeline.run_chunk, (3, 4), lambda: torch.OutOfMemoryError(OOM_TEXT), seen))
    t = check(models(THW)[1], device="cpu", **kw)
    assert (t.total, t.levels, t.violation.depth) == (ref.total, ref.levels, ref.violation.depth)
    assert [d["kind"] for d in t.stats["degradations"]] == ["compile_fallback", "chunk_degrade"]
    assert t.stats["pipeline_fallback"] is True and t.stats["adaptive_compile_fallback"] is True


@pytest.mark.parametrize("backend", ["device", "host"])
def test_allocation_failure_in_a_device_level_falls_back(backend, monkeypatch):
    """The 3rd level queued raises torch.OutOfMemoryError: the handler's
    degrade (escalated), the fallback naming the error, the level re-run on
    the per-chunk path from the pre-level state, the same result."""
    kw = dict(PIPE_KW, pipeline="device", visited_backend=backend)
    ref = check(models(THW)[1], device="cpu", **kw)
    assert ref.stats["device"]["levels"] > 3
    monkeypatch.setattr(tpipeline.DevicePipeline, "queue_level", failing(
        tpipeline.DevicePipeline.queue_level, (3,), lambda: torch.OutOfMemoryError(OOM_TEXT),
        []))
    t = check(models(THW)[1], device="cpu", **kw)
    assert outcome(t) == outcome(ref)
    assert t.stats["device"] == {"levels": 2, "fallback": f"OutOfMemoryError: {OOM_TEXT}"}
    assert t.stats["degradations"] == [{"kind": "compile_fallback", "depth": 2,
                                        "error": f"OutOfMemoryError: {OOM_TEXT}"}]


@pytest.mark.parametrize("where", ["chunk", "level"])
def test_sticky_cuda_error_raises(where, monkeypatch):
    """A CUDA runtime error loses the context: no retry, no degrade."""
    err = lambda: RuntimeError("CUDA error: an illegal memory access was encountered")  # noqa
    if where == "chunk":
        monkeypatch.setattr(tbfs, "run_chunk", failing(tpipeline.run_chunk, (2,), err, []))
        kw = dict(PIPE_KW, pipeline="fused")
    else:
        monkeypatch.setattr(tpipeline.DevicePipeline, "queue_level", failing(
            tpipeline.DevicePipeline.queue_level, (2,), err, []))
        kw = dict(PIPE_KW, pipeline="device")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        check(models(THW)[1], device="cpu", **kw)


# --- the shadow ------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.25, 0.5, 0.9, 1.0])
def test_sample_chunk_equals_jax(rate):
    grid = [(d, s) for d in range(0, 40) for s in (0, 1, 256, 32768, 65536, 10**6)]
    assert ([tinteg.sample_chunk(d, s, rate) for d, s in grid]
            == [jinteg.sample_chunk(d, s, rate) for d, s in grid])


def test_shadow_rate_equals_jax(monkeypatch):
    for arg in (None, 0, 0.5, 1.0, "0.25"):
        assert tinteg.shadow_rate(arg) == jinteg.shadow_rate(arg)
    monkeypatch.setenv("KSPEC_INTEGRITY_SHADOW", "0.3")
    assert tinteg.shadow_rate(None) == jinteg.shadow_rate(None) == 0.3
    for bad in (2, -0.5):
        with pytest.raises(ValueError) as te:
            tinteg.shadow_rate(bad)
        with pytest.raises(ValueError) as je:
            jinteg.shadow_rate(bad)
        assert str(te.value) == str(je.value)
    assert tinteg.ENV_SHADOW == jinteg.ENV_SHADOW


def shadow_spans(path):
    import json

    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    return [(r["depth"], r["start"], r["rows"], r["mode"]) for r in recs
            if r.get("span") == "shadow" and r.get("ph") != "B"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_shadow_count_equals_jax(backend, tmp_path):
    """integrity_shadow=1.0: the clean run's result, one host-oracle check
    per committed chunk, as many as JAX's kspec_integrity_shadow_total."""
    jm, tm = models("FRL")
    kw = dict(min_bucket=32, chunk_size=32, visited_backend=backend, integrity_shadow=1.0)
    jr = jrunctx.RunContext(str(tmp_path / "jax"))
    tr = trunctx.RunContext(str(tmp_path / "port"))
    j = jbfs.check(jm, run=jr, overlap=False, **kw)
    t = check(tm, run=tr, device="cpu", **kw)
    clean = check(tm, device="cpu", min_bucket=32, chunk_size=32, visited_backend=backend)
    assert outcome(t) == outcome(j) == outcome(clean)
    jn = jr.metrics.snapshot()["counters"]
    tn = tr.metrics.snapshot()["counters"]
    key = "kspec_integrity_shadow_total"
    assert tn[key] == jn[key] > 0
    spans = shadow_spans(tr.spans_path)
    assert spans == shadow_spans(jr.spans_path)
    assert len(spans) == tn[key] and {s[3] for s in spans} == {"host-oracle"}


def test_shadow_catches_a_flipped_fingerprint(monkeypatch):
    """One bit of one chunk's hi flipped between K1 and the commit: typed
    IntegrityError at site "shadow" (without the shadow the run would go
    on with a wrong fingerprint)."""
    model = models("FRL-hashed")[1]
    assert not model.spec.exact64  # K1's murmur3 path
    real, calls = tpipeline.fp_stage, [0]

    def flipping(spec, rows):
        hi, lo = real(spec, rows)
        calls[0] += 1
        if calls[0] == 3 and hi.shape[0]:
            hi = hi.clone()
            hi[0] ^= 1 << 9
        return hi, lo

    monkeypatch.setattr(tpipeline, "fp_stage", flipping)
    with pytest.raises(IntegrityError) as ei:
        check(model, device="cpu", min_bucket=32, integrity_shadow=1.0)
    assert ei.value.site == "shadow"
    assert "host fingerprint oracle mismatch" in str(ei.value)


def test_shadow_sends_pipeline_device_per_chunk_with_jax_reason():
    kw = dict(PIPE_KW, pipeline="device", integrity_shadow=1.0)
    j = jax_run(("shadow", "device"), None, THW, **kw)
    t = check(models(THW)[1], device="cpu", **kw)
    ref = check(models(THW)[1], device="cpu", **dict(PIPE_KW, pipeline="device"))
    assert ref.stats["device"]["levels"] > 0
    assert t.stats["device"] == j.stats["device"] == {
        "levels": 0, "fallback": "integrity shadow re-execution needs per-chunk replay"}
    assert outcome(t) == outcome(j) == outcome(ref)


def test_shadow_off_with_the_chain(monkeypatch):
    monkeypatch.setenv("KSPEC_INTEGRITY", "0")
    t = check(models("FRL")[1], device="cpu", min_bucket=32, pipeline="device",
              compact_gate=32, integrity_shadow=1.0)
    assert t.stats["device"]["fallback"] is None and t.total == 49


def test_cli_shadow_rate_out_of_range_equals_jax(tmp_path, capsys):
    """JAX's CLI lets the ValueError escape check(): exit 1, its last line."""
    argv = ["check", "configs/IdSequence.cfg", "--cpu", "--json", "--integrity-shadow", "2"]
    with pytest.raises(ValueError) as je:
        jcli(argv + ["--run-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    assert tcli.main(argv + ["--run-dir", str(tmp_path / "port")]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.splitlines()[-1] == f"ValueError: {je.value}"
    for mod in (jtracer, ttracer):
        mod.set_tracer(None)
    for mod in (jmet, tmet):
        mod.set_registry(None)
