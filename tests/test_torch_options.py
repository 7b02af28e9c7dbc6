"""PyTorch port: check()'s run options against the JAX engine's, with zero
tolerance, over the three visited backends: a `max_states` cut (levels, the
per-level stats lines' deterministic fields, `progress` calls,
`visited_capacity` and the backends' own sizes) on IdSequence, FRL(2,2,2)
and Kip320 2r; `store_trace=False`, `check_invariants=False` and the
invariant pass on a cut frontier on IdSequence with BelowBound; the
visited set's capacity hints; and the heartbeat envelope."""

import dataclasses
import json

import pytest

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import finite_replicated_log as jfrl
from kafka_specification_tpu.models import id_sequence as jids
from kafka_specification_tpu.models import kafka_replication as jkr
from kafka_specification_tpu.models import kip320 as jkip320
from kafka_specification_tpu.models.base import Invariant as JInvariant
from kafka_specification_tpu.resilience import heartbeat as jheartbeat
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.models import finite_replicated_log as tfrl
from kafka_specification_tpu_torch.models import id_sequence as tids
from kafka_specification_tpu_torch.models import kafka_replication as tkr
from kafka_specification_tpu_torch.models import kip320 as tkip320
from kafka_specification_tpu_torch.models.base import Invariant as TInvariant
from kafka_specification_tpu_torch.resilience import heartbeat
from torch_guards import overlap_guard  # noqa: F401  (autouse)

BACKENDS = ["device", "device-hash", "host"]
# the fields of a per-level stats record that do not depend on timing
DETERMINISTIC = ("kind", "depth", "frontier", "enabled_candidates", "new", "duplicates",
                 "total", "action_enablement")
KW = dict(min_bucket=32, chunk_size=256)
# (JAX model, port model, max_states): each cut a few levels before the end
CUTS = {
    "IdSequence": lambda: (jids.make_model(6), tids.make_model(6), 4),
    "FRL": lambda: (jfrl.make_model(2, 2, 2), tfrl.make_model(2, 2, 2), 17),
    "Kip320": lambda: (jkip320.make_model(jkr.Config(2, 2, 2, 2)),
                       tkip320.make_model(tkr.Config(2, 2, 2, 2)), 1000),
}
_MODELS: dict = {}


def models(name):
    """One model pair per name: the JAX package caches its compiled steps on
    the Model, so sharing it keeps this file's compiles to one set."""
    if name not in _MODELS:
        _MODELS[name] = CUTS[name]()
    return _MODELS[name]


def stats_lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def deterministic(records):
    return [{k: r[k] for k in DETERMINISTIC} for r in records]


def run_both(jm, tm, tmp_path, **kw):
    """Both engines with stats and progress on -> (JAX result, port result,
    JAX stats lines, port stats lines, JAX progress calls, port's)."""
    calls = {"jax": [], "port": []}
    jr = jbfs.check(jm, stats_path=str(tmp_path / "jax.jsonl"),
                    progress=lambda *a: calls["jax"].append(a), **kw)
    tr = check(tm, device="cpu", stats_path=str(tmp_path / "port.jsonl"),
               progress=lambda *a: calls["port"].append(a), **kw)
    return (jr, tr, stats_lines(tmp_path / "jax.jsonl"), stats_lines(tmp_path / "port.jsonl"),
            calls["jax"], calls["port"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(CUTS))
def test_max_states_cut_equals_jax(name, backend, tmp_path):
    jm, tm, max_states = models(name)
    jr, tr, jlines, tlines, jcalls, tcalls = run_both(
        jm, tm, tmp_path, max_states=max_states, visited_backend=backend, **KW)
    assert (tr.levels, tr.total, tr.diameter) == (jr.levels, jr.total, jr.diameter)
    assert tr.ok and jr.ok
    # cut at the first level boundary with total >= max_states
    assert tr.total >= max_states > tr.total - tr.levels[-1]
    assert deterministic(tlines) == deterministic(jlines)
    assert len(tlines) == len(tr.levels) - 1
    assert deterministic(tr.stats["levels"]) == deterministic(tlines)
    assert all(set(line) == set(j) for line, j in zip(tlines, jlines))  # same keys
    assert tcalls == jcalls == [(d, n, sum(tr.levels[: d + 1]))
                                for d, n in enumerate(tr.levels) if d]
    for key in ("visited_capacity", "hash_table_capacity", "hash_table_size", "host_fpset_size"):
        assert tr.stats.get(key) == jr.stats.get(key), key


def _below_bound():
    """IdSequence(5) with BelowBound (nextId <= 3): violated at depth 4."""
    jm, tm = jids.make_model(5), tids.make_model(5)
    return (dataclasses.replace(jm, invariants=[JInvariant("BelowBound", lambda s: s["nextId"] <= 3)]),
            dataclasses.replace(tm, invariants=[TInvariant("BelowBound", lambda s: s["nextId"] <= 3)]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_trace_no_invariants_and_the_cut_frontier(backend):
    jm, tm = _below_bound()
    kw = dict(visited_backend=backend, **KW)

    # store_trace=False: the violating state, and an empty trace
    jr = jbfs.check(jm, store_trace=False, **kw)
    tr = check(tm, device="cpu", store_trace=False, **kw)
    assert (tr.violation.invariant, tr.violation.depth, tr.violation.state) == \
        (jr.violation.invariant, jr.violation.depth, jr.violation.state) == ("BelowBound", 4, 4)
    assert tr.violation.trace == jr.violation.trace == []
    assert tr.levels == jr.levels

    # check_invariants=False: the whole space, no violation
    jr = jbfs.check(jm, check_invariants=False, **kw)
    tr = check(tm, device="cpu", check_invariants=False, **kw)
    assert tr.ok and jr.ok and tr.levels == jr.levels == [1] * 7

    # a max_states cut at depth 4 leaves state 4 unexpanded: its invariant
    # pass finds the violation, with and without the trace
    for store_trace in (True, False):
        jr = jbfs.check(jm, max_states=5, store_trace=store_trace, **kw)
        tr = check(tm, device="cpu", max_states=5, store_trace=store_trace, **kw)
        assert tr.levels == jr.levels == [1] * 5
        assert (tr.violation.depth, tr.violation.state) == (jr.violation.depth, jr.violation.state)
        assert tr.violation.trace == jr.violation.trace
        assert len(tr.violation.trace) == (5 if store_trace else 0)


@pytest.mark.parametrize("knob", [dict(visited_capacity_hint=1000),
                                  dict(visited_capacity_exact=4096),
                                  dict(visited_capacity_hint=100, visited_capacity_exact=8192)])
@pytest.mark.parametrize("backend", ["device", "device-hash"])
def test_visited_capacity_hints_equal_jax(backend, knob):
    jm, tm, _ = models("FRL")
    jr = jbfs.check(jm, visited_backend=backend, **knob, **KW)
    tr = check(tm, device="cpu", visited_backend=backend, **knob, **KW)
    assert tr.levels == jr.levels
    assert tr.stats["visited_capacity"] == jr.stats["visited_capacity"]
    assert tr.stats.get("hash_table_capacity") == jr.stats.get("hash_table_capacity")
    if backend == "device":
        base = check(tm, device="cpu", visited_backend=backend, **KW)
        assert tr.stats["visited_capacity"] > base.stats["visited_capacity"]


def test_heartbeat_envelope_equals_jax(tmp_path):
    fields = dict(depth=3, frontier=12, new=4, action_enablement={"A": 1})
    rec = heartbeat.heartbeat_record("level", t=1792216844.1337, **fields)
    assert rec == jheartbeat.heartbeat_record("level", t=1792216844.1337, **fields)
    assert list(rec) == ["kind", "ts", "unix", "depth", "frontier", "new", "action_enablement"]
    heartbeat.append_jsonl(str(tmp_path / "port.jsonl"), rec)
    jheartbeat.append_jsonl(str(tmp_path / "jax.jsonl"), rec)
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
