"""The five-broker bounded run of the PyTorch port
(scripts/torch_run_5broker_bounded.py): Kip320 at 5 replicas, LogSize 2,
MaxRecords 2, MaxLeaderEpoch 2, held level by level against the JAX
package's committed record of the same check, RUN5R_r5_stats.jsonl
(scripts/run_5broker_bounded.py's stats stream, 15 levels, 195,528,316
states), with zero tolerance.

A live JAX check of this model spends tens of seconds in XLA compiles on
the CPU before its first level, which this suite cannot pay.  The
model's kernels at 5 replicas are held live against the JAX package
through the Stretch product, whose partitions are this model
(tests/test_torch_cli.py::test_stretch_product_cut_at_depth_3).  The
record stands in for the JAX side here, and for the depths past the
CPU's reach on the card (chip_smoke.py phase `five-broker`)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.engine.pipeline import invariant_pass, invariant_stage
from kafka_specification_tpu_torch.models.base import Invariant
from torch_guards import overlap_guard, torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
RECORD = REPO / "RUN5R_r5_stats.jsonl"
SCRIPT = REPO / "scripts" / "torch_run_5broker_bounded.py"


def _script():
    spec = importlib.util.spec_from_file_location("torch_run_5broker_bounded", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


run5 = _script()


@pytest.fixture(scope="module")
def script_run(tmp_path_factory):
    """One run of the script as a user runs it (--cpu, to depth 4, held
    against the record), started here so that it runs beside the
    in-process check below."""
    proc = subprocess.Popen(
        [sys.executable, str(SCRIPT), "--cpu", "--max-depth", "4", "--visited-backend",
         "device", "--against", str(RECORD)],
        cwd=tmp_path_factory.mktemp("script"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def depth7(tmp_path_factory, script_run):
    """The port's check() of the 5-broker model on the CPU to depth 7
    (271,071 states), with its stats stream and every level's rows (the
    chunk size changes no record: 16384 is the CPU's quickest)."""
    stats = tmp_path_factory.mktemp("d7") / "stats.jsonl"
    levels = []
    with torch_threads():  # a module fixture runs before overlap_guard sets them
        res = check(run5.make_model(), device="cpu", max_depth=7, store_trace=False,
                    stats_path=str(stats), chunk_size=16384, collect_levels=levels)
    return res, [json.loads(line) for line in stats.read_text().splitlines()], levels


def test_levels_1_to_7_equal_the_jax_record(depth7):
    """Each level's frontier, enabled candidates, new, duplicates, total
    and per-action enablement equal the JAX package's record, through the
    script's own comparison."""
    res, got, _ = depth7
    assert res.ok and res.total == 271_071 and res.diameter == 7
    record = run5.read_record(RECORD)
    assert run5.hold_levels(got, record) == 7
    assert res.levels[1:] == [record[d]["new"] for d in range(1, 8)]


def test_the_comparison_names_the_first_field_that_differs():
    record = run5.read_record(RECORD)
    assert sorted(record) == list(range(1, 16)) and record[15]["total"] == 195_528_316
    good = {k: record[3][k] for k in ("depth", *run5.RECORD_FIELDS)}
    run5.hold_level(good, record[3])
    for field in run5.RECORD_FIELDS:
        bad = json.loads(json.dumps(good))
        if field == "action_enablement":
            bad[field]["LeaderWrite"] += 1
        else:
            bad[field] += 1
        with pytest.raises(run5.RecordMismatch, match=f"depth 3: {field} is"):
            run5.hold_level(bad, record[3])
    with pytest.raises(run5.RecordMismatch, match="depth 3 held against"):
        run5.hold_level(good, record[4])


@pytest.mark.parametrize("argv, minutes, depth, chunk", [
    ([], 60.0, None, 131072),
    (["--max-depth", "15"], 60.0, 15, 131072),
    (["--max-depth=15"], 60.0, 15, 131072),
    (["30", "--max-depth", "15"], 30.0, 15, 131072),
    (["--max-depth", "15", "30"], 30.0, 15, 131072),
    (["--max-depth", "12", "--chunk", "4096", "7.5"], 7.5, 12, 4096),
    (["--chunk=8192", "--max-depth=3"], 60.0, 3, 8192),
])
def test_the_command_line_is_the_jax_scripts(argv, minutes, depth, chunk):
    """MINUTES is positional, --max-depth and --chunk take either form,
    and the two-token form's value is never read as MINUTES."""
    args = run5.parse_args(argv)
    assert (args.minutes, args.max_depth, args.chunk) == (minutes, depth, chunk)
    assert (args.visited_backend, args.pipeline, args.store_trace, args.cpu) == (
        "host", None, False, False)


def test_the_script_runs_on_the_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run5.main(["--max-depth", "1"])


def test_the_script_prints_the_jax_scripts_lines(script_run):
    """The script's run: a line a level with the JAX script's keys, the
    final line with its keys, and the levels held against the record."""
    stdout, stderr = script_run.communicate(timeout=120)
    assert script_run.returncode == 0, stderr
    lines = [json.loads(line) for line in stdout.splitlines()]
    assert [r["depth"] for r in lines[:-1]] == [1, 2, 3, 4]
    for rec in lines[:-1]:
        assert set(rec) == {"depth", "new", "total", "elapsed_s", "states_per_sec", "rss_gb"}
    final = lines[-1]
    assert {"final", "ok", "total", "diameter", "seconds", "states_per_sec"} <= set(final)
    assert (final["ok"], final["total"], final["diameter"], final["levels_held"]) == (
        True, 3241, 4, 4)
    assert (final["pipeline_fallback"], final["degradations"]) == (False, 0)


def test_the_cut_frontiers_invariant_pass_by_pieces_equals_the_whole(depth7):
    """check()'s invariant pass over a frontier cut by max_depth unpacks a
    chunk at a time (a whole level of 5-replica states does not fit beside
    the visited set at depth 15): for every piece size it gives what the
    whole level gives, the first violated invariant in model order and its
    first row."""
    model = run5.make_model()
    rows = depth7[2][4]  # level 4: 2,370 states
    spec = model.spec
    # two invariants, each failing on one row of the level; the later one
    # in model order fails first in the level
    fails = {"A": rows.shape[0] - 3, "B": 5}

    def fails_at(name):
        target = rows[fails[name]]
        return lambda st: ~(spec.pack(st) == target).all(1)

    for invs in ([], ["A"], ["B"], ["A", "B"], ["B", "A"]):
        m = dataclasses.replace(model, invariants=[Invariant(n, fails_at(n)) for n in invs],
                                invariants_fused=None)
        whole = invariant_stage(m, spec.unpack(rows))
        assert whole == ((invs[0], fails[invs[0]]) if invs else None)
        for piece in (13, 256, rows.shape[0]):
            pieces = ((s, rows[s : s + piece]) for s in range(0, rows.shape[0], piece))
            assert invariant_pass(m, pieces) == whole, (invs, piece)
    assert invariant_pass(model, ((s, rows[s : s + 50]) for s in range(0, 100, 50))) is None
