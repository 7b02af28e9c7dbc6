"""PyTorch port: the run context and its telemetry (``obs/``) against the
JAX package's, with zero tolerance on everything that is not a clock.

Held unit for unit on the same input: the run id's format, the manifest's
keys and lineage on open, reopen and finish; the tracer's nesting and its
torn lines; ``parse_xprof``; the Prometheus text of the same operations;
the stats shim record for record.  Held run against run: ``check(run=)``
of each package on TruncateToHW 2r (its WeakIsr violation) and Kip101 2r,
on ``fused``, ``device``, the disk tier at 1M and the forced-spill tier:
the file set, the manifest's keys, config and result, the span kinds (and
their attributes) per level, and every gauge and counter that does not
depend on a clock.  Where the two cannot agree, the test says why:

- the JAX package's ``compile`` spans (an XLA compile; the port has none);
- ``launches`` and ``kspec_successor_launches_level``: JAX counts XLA
  programs, the port its chunk step dispatches (held by key);
- the overlap layer's gauges, which the JAX engine sets even with
  ``overlap=False`` and the port leaves unset until it has the layer
  (``cli report`` then omits the overlap beat).

Then ``cli report`` (text and ``--json``) of each package on the other's
run directory and on ``tests/data/mini_run``, a crashed run's directory,
the un-homed spill under ``<run>/spill``, the exit-75 manifest and beat,
and the profiler windows on the CPU (``KSPEC_OBS_XPROF``, ``--profile``).

Every test ends with the current tracer and registry of both packages
unset, no profiler running, ``KSPEC_FAULT`` as it found it and every run
directory under its own ``tmp_path`` (the autouse fixture checks it)."""

import json
import os
import re
import time
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.obs import metrics as jmet
from kafka_specification_tpu.obs import report as jreport
from kafka_specification_tpu.obs import runctx as jrunctx
from kafka_specification_tpu.obs import tracer as jtracer
from kafka_specification_tpu.resilience.faults import InjectedCrash as JInjectedCrash
from kafka_specification_tpu.utils.cli import main as jcli
from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch import cli as tcli
from kafka_specification_tpu_torch.models import variants as tvariants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.obs import metrics as tmet
from kafka_specification_tpu_torch.obs import report as treport
from kafka_specification_tpu_torch.obs import runctx as trunctx
from kafka_specification_tpu_torch.obs import tracer as ttracer
from kafka_specification_tpu_torch.resilience.faults import InjectedCrash

pytestmark = pytest.mark.obs

REPO = Path(__file__).resolve().parents[1]
MINI_RUN = REPO / "tests" / "data" / "mini_run"
THW = "KafkaTruncateToHighWatermark"
INVARIANTS = {THW: ("TypeOk", "WeakIsr"), "Kip101": ("TypeOk", "LeaderInIsr", "WeakIsr")}
# span attributes that read a clock, or count what only one package has
SPAN_VOLATILE = ("ts", "unix", "t0", "ms", "span_id", "parent_id", "run_id", "dispatch_ms",
                 "wait_ms", "queued_ms", "launches")
# stats-line fields that read a clock (and the run-correlation stamp)
LEVEL_VOLATILE = ("ts", "unix", "level_ms", "step_ms", "host_ms", "run_id")
# metrics that read a clock or the process, held by key only
METRIC_BY_KEY = ("kspec_successor_launches_level", "kspec_rss_bytes", "kspec_states_per_sec",
                 "kspec_level_ms", "kspec_step_ms_total", "kspec_host_ms_total",
                 "kspec_host_probe_ms")
# the JAX engine's overlap-layer metrics (set even with overlap=False)
JAX_ONLY_METRICS = ("kspec_overlap_efficiency", "kspec_io_hidden_ms_total",
                    "kspec_io_exposed_ms_total")
# manifest fields that read a clock or the process
MANIFEST_VOLATILE = ("run_id", "pid", "argv", "cwd", "git", "created", "created_unix")


@pytest.fixture(autouse=True)
def _no_leaks(tmp_path, monkeypatch):
    """Every run directory lands under tmp_path; afterwards neither
    package has a current tracer or registry, no profiler runs and
    KSPEC_FAULT is as it was."""
    fault = os.environ.get("KSPEC_FAULT")
    monkeypatch.setenv("KSPEC_RUNS_ROOT", str(tmp_path / "runs"))
    monkeypatch.delenv("KSPEC_OBS_XPROF", raising=False)
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    for mod in (jtracer, ttracer):
        mod.set_tracer(None)
    for mod in (jmet, tmet):
        mod.set_registry(None)
    yield
    monkeypatch.undo()  # a test's own setenv("KSPEC_FAULT") is not a leak
    leaked = [name for name, cur in (
        ("jax tracer", jtracer.current_tracer()), ("port tracer", ttracer.current_tracer()),
        ("jax registry", jmet.current_registry()), ("port registry", tmet.current_registry()),
    ) if cur is not None]
    for mod in (jtracer, ttracer):
        mod.set_tracer(None)
    for mod in (jmet, tmet):
        mod.set_registry(None)
    left = os.environ.get("KSPEC_FAULT")
    if fault is None:
        os.environ.pop("KSPEC_FAULT", None)
    else:
        os.environ["KSPEC_FAULT"] = fault
    assert not leaked, f"left set: {leaked}"
    assert not torch.autograd.profiler._is_profiler_enabled, "a profiler is still running"
    assert left == fault, f"KSPEC_FAULT left as {left!r}"


def reset_globals():
    """What a crashed run leaves set in its thread, in both packages."""
    for mod in (jtracer, ttracer):
        mod.set_tracer(None)
    for mod in (jmet, tmet):
        mod.set_registry(None)


def models(variant):
    inv = INVARIANTS[variant]
    return (jvariants.make_model(variant, JConfig(2, 2, 1, 1), inv),
            tvariants.make_model(variant, Config(2, 2, 1, 1), inv))


def records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh.read().splitlines()]


def strip(rec, volatile):
    return {k: v for k, v in rec.items() if k not in volatile}


def spans_by_level(path):
    """depth -> [(span, ph, deterministic attributes)], events apart; the
    JAX package's compile spans dropped."""
    out = {}
    for r in records(path):
        if r["kind"] == "event":
            out.setdefault("events", []).append(r["event"])
        elif r["span"] != "compile":
            out.setdefault(r.get("depth"), []).append(
                (r["span"], r["ph"], strip(r, SPAN_VOLATILE)))
    return out


def prom(path):
    """{series without its run_id label: value} of a metrics.prom."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            key, value = line.rsplit(" ", 1)
            out[re.sub(r',?run_id="[^"]*"', "", key).replace("{}", "")] = value.strip()
    return out


def base(series):
    return series.split("{", 1)[0].removesuffix("_bucket").removesuffix("_sum").removesuffix(
        "_count")


def manifest(run):
    with open(run.manifest_path) as fh:
        return json.load(fh)


def run_pair(tmp_path, variant, kw, jkw=None):
    """The same check under a run context of each package -> the two
    contexts and results."""
    jmodel, tmodel = models(variant)
    jr = jrunctx.RunContext(str(tmp_path / "jax"))
    tr = trunctx.RunContext(str(tmp_path / "port"))
    jres = jbfs.check(jmodel, run=jr, overlap=False, **kw, **(jkw or {}))
    tres = check(tmodel, run=tr, device="cpu", **kw)
    return jr, tr, jres, tres


def assert_same_run_dirs(jr, tr):
    """File set, manifest keys, config and result, spans per level, and
    every clock-free metric of two run directories of the same check."""
    assert sorted(os.listdir(tr.dir)) == sorted(os.listdir(jr.dir))
    jm, tm = manifest(jr), manifest(tr)
    assert sorted(tm) == sorted(jm)
    assert tm["config"] == jm["config"]
    assert tm["status"] == jm["status"]
    assert ([e["event"] for e in tm["lineage"]] == [e["event"] for e in jm["lineage"]])
    assert strip(tm.get("result", {}), ("seconds", "states_per_sec")) == strip(
        jm.get("result", {}), ("seconds", "states_per_sec"))
    assert ([strip(r, LEVEL_VOLATILE) for r in records(tr.stats_path)]
            == [strip(r, LEVEL_VOLATILE) for r in records(jr.stats_path)])
    assert all(r["run_id"] == tr.run_id for r in records(tr.stats_path))
    assert spans_by_level(tr.spans_path) == spans_by_level(jr.spans_path)
    pj, pt = prom(jr.metrics_prom), prom(tr.metrics_prom)
    assert {k for k in pj if base(k) not in JAX_ONLY_METRICS} == set(pt)
    assert ({k: v for k, v in pt.items() if base(k) not in METRIC_BY_KEY}
            == {k: v for k, v in pj.items() if base(k) not in METRIC_BY_KEY + JAX_ONLY_METRICS})
    assert all(f'run_id="{tr.run_id}"' in line for line in open(tr.metrics_prom)
               if not line.startswith("#"))


# --- units, against the JAX package's --------------------------------------------


def test_run_id_format_and_manifest_lineage_equal_jax(tmp_path):
    rid = trunctx.new_run_id()
    assert re.fullmatch(r"\d{8}T\d{6}-%d-[0-9a-f]{4}" % os.getpid(), rid)
    assert len(rid) == len(jrunctx.new_run_id())
    assert trunctx.default_run_dir("x") == jrunctx.default_run_dir("x") == str(
        tmp_path / "runs" / "x")
    mans = []
    for mod, name in ((jrunctx, "j"), (trunctx, "t")):
        run = mod.RunContext(str(tmp_path / name))
        opened = manifest(run)
        run.record_config(module="Toy", engine="bfs", cfg=None)
        run.finish("complete", distinct_states=42)
        finished = manifest(run)
        again = mod.RunContext(str(tmp_path / name))  # a resume keeps the run id
        assert again.run_id == run.run_id
        again.tracer.close()
        run.tracer.close()
        mans.append((opened, finished, manifest(again)))
    for j, t in zip(mans[0], mans[1]):
        assert list(t) == list(j)  # the same keys, in the same order
        assert strip(t, MANIFEST_VOLATILE + ("lineage",)) == strip(j, MANIFEST_VOLATILE + (
            "lineage",))
        assert [strip(e, ("pid", "ts", "unix")) for e in t["lineage"]] == [
            strip(e, ("pid", "ts", "unix")) for e in j["lineage"]]
    assert [e["event"] for e in mans[1][2]["lineage"]] == ["open", "finish", "reopen"]
    assert mans[1][2]["status"] == "running" and mans[1][1]["result"] == {"distinct_states": 42}


def test_default_run_dir_under_runs_root(tmp_path):
    run = trunctx.RunContext()
    assert run.dir.startswith(str(tmp_path / "runs"))
    assert os.path.isfile(run.manifest_path) and os.path.basename(run.dir) == run.run_id


def test_tracer_nesting_and_torn_lines_equal_jax(tmp_path):
    outs = []
    for mod, name in ((jtracer, "j"), (ttracer, "t")):
        p = str(tmp_path / f"{name}.jsonl")
        tr = mod.SpanTracer(p, "run-x")
        with tr.span("outer", depth=3):
            with tr.span("inner", item=1):
                pass
            tr.event("retry", attempt=1)
            tr.begin("level", depth=4)
            tr.end("level", time.time(), depth=4)
        tr.close()
        recs = mod.read_jsonl_tolerant(p)
        whole = open(p, "rb").read()
        lines = whole.split(b"\n")
        lines[1] = lines[1][:10]  # a tear mid-file, as a resume appends past it
        open(p, "wb").write(b"\n".join(lines)[:-17])  # and the final line torn
        outs.append((recs, mod.read_jsonl_tolerant(p)))
    (jrecs, jtorn), (trecs, ttorn) = outs
    keep = ("kind", "ph", "span", "event", "span_id", "parent_id", "run_id", "depth", "item",
            "attempt")
    assert [{k: r[k] for k in keep if k in r} for r in trecs] == [
        {k: r[k] for k in keep if k in r} for r in jrecs]
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]
    inner, ev, begin, level, outer = trecs
    assert inner["parent_id"] == outer["span_id"] == level["parent_id"]
    assert len(ttorn) == len(jtorn) == 3
    assert [r.get("span", r.get("event")) for r in ttorn] == ["inner", "level", "level"]


@pytest.mark.parametrize("spec", [None, "", "level", "level:3", "spill-merge:2-7", " step :0-1"])
def test_parse_xprof_equals_jax(spec):
    assert ttracer.parse_xprof(spec) == jtracer.parse_xprof(spec)


@pytest.mark.parametrize("spec", ["level:x", ":3", "level:1-y", "level:-"])
def test_parse_xprof_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as je:
        jtracer.parse_xprof(spec)
    with pytest.raises(ValueError) as te:
        ttracer.parse_xprof(spec)
    assert str(te.value) == str(je.value)


def test_prom_and_jsonl_exports_equal_jax(tmp_path):
    texts = []
    for mod, name in ((jmet, "j"), (tmet, "t")):
        m = mod.MetricsRegistry("run-y")
        m.inc("kspec_states_total", 10)
        m.inc("kspec_states_total", 5)
        m.set_gauge("kspec_frontier", 123)
        m.set_gauge("kspec_shard_new", 7, shard=1)
        for v in (42.0, 9000.0, 5.0, 1e9):
            m.observe("kspec_level_ms", v)
        m.write_prom(str(tmp_path / f"{name}.prom"))
        m.write_jsonl(str(tmp_path / f"{name}.jsonl"))
        texts.append((open(tmp_path / f"{name}.prom").read(),
                      strip(records(tmp_path / f"{name}.jsonl")[0], ("ts", "unix"))))
    assert texts[1] == texts[0]
    assert 'kspec_shard_new{shard="1",run_id="run-y"} 7' in texts[1][0]


def test_stats_shim_record_for_record(tmp_path):
    """With only stats_path the stream carries no run_id and equals the
    JAX package's; under a run context the same records gain the run id
    and land in the run directory, and stats["levels"] holds them."""
    jmodel, tmodel = models("Kip101")
    bare, jbare = str(tmp_path / "bare.jsonl"), str(tmp_path / "jbare.jsonl")
    r1 = check(tmodel, device="cpu", stats_path=bare)
    jbfs.check(jmodel, stats_path=jbare, overlap=False)
    run = trunctx.RunContext(str(tmp_path / "run"))
    r2 = check(tmodel, device="cpu", run=run)
    assert r1.total == r2.total
    recs_bare, recs_run = records(bare), records(run.stats_path)
    assert list(recs_bare[0]) == list(records(jbare)[0]) == [
        "kind", "ts", "unix", "depth", "frontier", "enabled_candidates", "new", "duplicates",
        "total", "level_ms", "step_ms", "host_ms", "action_enablement"]
    assert [strip(r, LEVEL_VOLATILE) for r in recs_bare] == [
        strip(r, LEVEL_VOLATILE) for r in records(jbare)]
    assert [strip(r, LEVEL_VOLATILE) for r in recs_bare] == [
        strip(r, LEVEL_VOLATILE) for r in recs_run]
    assert all("run_id" not in r for r in recs_bare)
    assert all(list(r)[3] == "run_id" and r["run_id"] == run.run_id for r in recs_run)
    assert r1.stats["levels"] == recs_bare and r2.stats["levels"] == recs_run


# --- check(run=) against the JAX package's -----------------------------------------

CASES = {
    "thw-fused": (THW, dict(min_bucket=256)),
    "thw-device": (THW, dict(pipeline="device", chunk_size=256, compact_gate=32,
                             min_bucket=256)),
    "thw-tier-1M": (THW, dict(mem_budget="1M", min_bucket=256)),
    "kip101-fused": ("Kip101", dict(min_bucket=256)),
    "kip101-device": ("Kip101", dict(pipeline="device", chunk_size=256, compact_gate=32,
                                     min_bucket=256)),
    "kip101-tier-1M": ("Kip101", dict(mem_budget="1M", min_bucket=256)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_run_dir_equals_jax(tmp_path, case):
    variant, kw = CASES[case]
    jr, tr, jres, tres = run_pair(tmp_path, variant, kw)
    assert (tres.total, tres.levels) == (jres.total, jres.levels)
    assert (tres.violation is None) == (jres.violation is None) == (variant != THW)
    assert_same_run_dirs(jr, tr)
    spans = spans_by_level(tr.spans_path)
    # one level B/E pair for each level record, and a step span in each
    for rec in records(tr.stats_path):
        kinds = [s[:2] for s in spans[rec["depth"]]]
        assert kinds.count(("level", "B")) == kinds.count(("level", "E")) == 1
        steps = [s[2] for s in spans[rec["depth"] - 1] if s[0] == "step"]
        assert steps and all(("pipeline" in st) == (kw.get("pipeline") == "device")
                             for st in steps)
    assert manifest(tr)["status"] == ("violation" if tres.violation else "complete")


def test_forced_spill_run_dir_equals_jax(tmp_path, monkeypatch):
    """The JAX package's forced-spill fixture: spill-run-write and
    spill-merge spans, the spill counters and finish-time spill gauges."""
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    jr, tr, jres, tres = run_pair(tmp_path, "Kip101", dict(mem_budget=300, min_bucket=256))
    assert tres.total == jres.total
    assert_same_run_dirs(jr, tr)
    kinds = {s[0] for v in spans_by_level(tr.spans_path).values() if isinstance(v, list)
             for s in v if isinstance(s, tuple)}
    assert {"spill-run-write", "spill-merge"} <= kinds
    pt = prom(tr.metrics_prom)
    assert int(pt["kspec_spill_runs_total"]) >= 2 and int(pt["kspec_spill_merges_total"]) >= 1
    assert "kspec_spill_disk_fps" in pt and "kspec_bloom_maybe_total" in pt


def test_host_backend_device_level_probe_gauge(tmp_path):
    """The host backend's device level: one host-probe span a level and
    the kspec_host_probe_ms gauge (by key), as in the JAX package."""
    jr, tr, jres, tres = run_pair(tmp_path, "Kip101", dict(
        visited_backend="host", pipeline="device", chunk_size=256, compact_gate=32,
        min_bucket=256))
    assert_same_run_dirs(jr, tr)
    spans = spans_by_level(tr.spans_path)
    probes = [d for d, v in spans.items() if d != "events" and any(s[0] == "host-probe"
                                                                     for s in v)]
    assert sorted(probes) == list(range(tres.diameter + 1))
    assert "kspec_host_probe_ms" in prom(tr.metrics_prom)
    data = treport.report_data(tr.dir)
    assert data["host_probe"]["present"] and data["launches"]["present"]


def test_run_none_clears_the_globals_and_close_deactivates(tmp_path):
    _, tmodel = models("Kip101")
    run = trunctx.RunContext(str(tmp_path / "r"))
    run.activate()
    assert ttracer.current_tracer() is run.tracer and tmet.current_registry() is run.metrics
    check(tmodel, device="cpu", max_depth=1)  # run=None clears both
    assert ttracer.current_tracer() is None and tmet.current_registry() is None
    run.tracer.close()


# --- crashed runs, the typed exit, cli report --------------------------------------


def test_crashed_run_dir_equals_jax_and_renders(tmp_path, monkeypatch):
    """crash@level:4 fires at the level-4 boundary, after level 4's E and
    before level 5's B, in both packages: the manifest stays at running,
    and `cli report` gives the stall rule's verdict (stalled past the
    timeout, since this process is alive).  crash@merge:1 on the forced
    spill fixture dies inside a level: its B has no E, and the report
    says so."""
    jmodel, tmodel = models("Kip101")
    for fault, extra in (("crash@level:4", {}), ("crash@merge:1", dict(mem_budget=300))):
        if extra:
            monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
            monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
        monkeypatch.setenv("KSPEC_FAULT", fault)
        sub = tmp_path / fault.replace("@", "-").replace(":", "-")
        jr = jrunctx.RunContext(str(sub / "jax"))
        tr = trunctx.RunContext(str(sub / "port"))
        with pytest.raises(JInjectedCrash):
            jbfs.check(jmodel, run=jr, overlap=False, **extra)
        with pytest.raises(InjectedCrash):
            check(tmodel, run=tr, device="cpu", **extra)
        assert ttracer.current_tracer() is tr.tracer  # a crash tears nothing down
        reset_globals()
        jr.tracer.close()
        tr.tracer.close()
        assert manifest(tr)["status"] == manifest(jr)["status"] == "running"
        assert sorted(os.listdir(tr.dir)) == sorted(os.listdir(jr.dir))
        assert spans_by_level(tr.spans_path) == spans_by_level(jr.spans_path)
        later = time.time() + 10_000
        for d in (jr.dir, tr.dir):
            assert treport.render_report(d, now=later) == jreport.render_report(d, now=later)
        data = treport.report_data(tr.dir, now=later)
        assert data["verdict"]["status"] == "stalled"
        text = treport.render_report(tr.dir, now=later)
        assert "[STALLED]" in text and "Stall verdict: stalled" in text
        if fault == "crash@level:4":
            assert data["open_level"] is None and len(data["levels"]) == 4
        else:
            assert data["open_level"] is not None
            assert f"died mid-level: level {data['open_level']} began" in text
    monkeypatch.delenv("KSPEC_FAULT")


def cli_report_text(main, run_dir, capsys):
    assert main(["report", str(run_dir)]) == 0
    return [line for line in capsys.readouterr().out.splitlines()
            if "last_heartbeat_age_s" not in line]


def cli_report_json(main, run_dir, capsys):
    assert main(["report", str(run_dir), "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    data["verdict"]["detail"].pop("last_heartbeat_age_s", None)
    return data


def test_cli_report_each_package_on_the_others_run_dir(tmp_path, capsys):
    """`cli check --run-dir` of each package, then `cli report` of each
    package on both directories and on tests/data/mini_run: the same text
    and record (a live verdict's heartbeat age aside)."""
    cfg = REPO / "configs" / "IdSequence.cfg"
    assert jcli(["check", str(cfg), "--hand", "--run-dir", str(tmp_path / "jax"),
                 "--json"]) == 0
    jrec = json.loads(capsys.readouterr().out)
    assert tcli.main(["check", str(cfg), "--cpu", "--run-dir", str(tmp_path / "port"),
                      "--json"]) == 0
    out = capsys.readouterr()
    trec = json.loads(out.out)
    tman = json.load(open(tmp_path / "port" / "manifest.json"))
    assert trec["run_id"] == tman["run_id"] and re.fullmatch(r"\d{8}T\d{6}-\d+-[0-9a-f]{4}",
                                                             trec["run_id"])
    assert out.err == f"[obs] run dir: {tmp_path / 'port'} (run {trec['run_id']})\n"
    jman = json.load(open(tmp_path / "jax" / "manifest.json"))
    assert tman["config"] == {**jman["config"], "cfg": str(cfg)} and jrec["run_id"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for d in (tmp_path / "jax", tmp_path / "port", MINI_RUN):
        assert cli_report_text(tcli.main, d, capsys) == cli_report_text(jcli, d, capsys)
        assert cli_report_json(tcli.main, d, capsys) == cli_report_json(jcli, d, capsys)
    text = cli_report_text(tcli.main, tmp_path / "port", capsys)
    assert text[0] == f"Run {trec['run_id']}  [COMPLETE]" and "Stall verdict: complete" in text
    assert "  NextId           11  100.0%" in text
    mini = "\n".join(cli_report_text(tcli.main, MINI_RUN, capsys))
    assert "died mid-level: level 9" in mini and "imbalance max/mean" in mini
    # the index of a runs root, and --latest
    assert tcli.main(["report", "--root", str(tmp_path)]) == 0
    index = capsys.readouterr().out
    assert jcli(["report", "--root", str(tmp_path)]) == 0
    assert index == capsys.readouterr().out and trec["run_id"] in index
    assert tcli.main(["report", "--latest", "--root", str(tmp_path / "none")]) == 1
    assert capsys.readouterr().err == f"no runs under {tmp_path / 'none'}\n"


def test_unhomed_spill_under_the_run_dir(tmp_path, capsys, monkeypatch):
    """--mem-budget with neither --spill-dir nor --checkpoint spills under
    <run>/spill, which a completed run removes; a crashed run leaves it,
    as the JAX package's CLI does."""
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    cfg = REPO / "configs" / "IdSequence.cfg"
    d = tmp_path / "done"
    assert tcli.main(["check", str(cfg), "--cpu", "--run-dir", str(d), "--mem-budget", "1K",
                      "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["distinct_states"] == 12 and not (d / "spill").exists()
    man = json.load(open(d / "manifest.json"))
    assert man["config"]["store"] == "disk" and man["config"]["mem_budget"] == 1024
    crashed = tmp_path / "crashed"
    with pytest.raises(InjectedCrash):
        tcli.main(["check", str(cfg), "--cpu", "--run-dir", str(crashed), "--mem-budget", "1K",
                   "--fault", "crash@level:5"])
    reset_globals()
    os.environ.pop("KSPEC_FAULT")  # the CLI exports it, as the JAX package's does
    assert (crashed / "spill").is_dir() and os.listdir(crashed / "spill")
    capsys.readouterr()


def test_exit_75_manifest_and_report_beat_equal_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "13")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    cfg = REPO / "configs" / "FiniteReplicatedLog.cfg"
    args = ["--min-bucket", "32", "--mem-budget", "300", "--fault", "enospc@spill:1", "--json"]
    outs = {}
    for main, name, extra in ((jcli, "jax", ["--hand", "--overlap", "off"]),
                              (tcli.main, "port", ["--cpu"])):
        d = tmp_path / name
        rc = main(["check", str(cfg), *extra, "--checkpoint", str(tmp_path / f"ck-{name}"),
                   "--run-dir", str(d), *args])
        os.environ.pop("KSPEC_FAULT")
        out = capsys.readouterr()
        rec = json.loads(out.out)
        assert rc == 75 and rec["exit_code"] == 75
        assert rec["run_id"] == json.load(open(d / "manifest.json"))["run_id"]
        outs[name] = (rec, json.load(open(d / "manifest.json")), d,
                      out.err.split("\n", 1)[1])
    (jrec, jman, jd, jerr), (trec, tman, td, terr) = outs["jax"], outs["port"]
    assert strip(trec, ("run_id",)) == strip(jrec, ("run_id",))
    assert terr.replace("ck-port", "ck-jax") == jerr
    assert tman["status"] == jman["status"] == "resource-exhausted"
    assert tman["result"] == jman["result"]
    tbeat = [line for line in cli_report_text(tcli.main, td, capsys)
             if "RESOURCE EXHAUSTED" in line or line.startswith("  next:")]
    jbeat = [line for line in cli_report_text(jcli, jd, capsys)
             if "RESOURCE EXHAUSTED" in line or line.startswith("  next:")]
    assert tbeat == jbeat and len(tbeat) == 2
    events = [r["event"] for r in records(td / "spans.jsonl") if r["kind"] == "event"]
    assert events == [r["event"] for r in records(jd / "spans.jsonl") if r["kind"] == "event"]


def test_integrity_exit_76_manifest_equals_jax(tmp_path, monkeypatch):
    """flip@frontier: the typed integrity exit stamps the manifest and
    records the violation event and counter, as the JAX engine does."""
    jmodel, tmodel = models("Kip101")
    monkeypatch.setenv("KSPEC_FAULT", "flip@frontier:3")
    jr = jrunctx.RunContext(str(tmp_path / "jax"))
    tr = trunctx.RunContext(str(tmp_path / "port"))
    with pytest.raises(Exception) as je:
        jbfs.check(jmodel, run=jr, overlap=False)
    with pytest.raises(Exception) as te:
        check(tmodel, run=tr, device="cpu")
    assert type(te.value).__name__ == type(je.value).__name__ == "IntegrityError"
    jm, tm = manifest(jr), manifest(tr)
    assert tm["status"] == jm["status"] == "integrity-violation"
    assert strip(tm["result"], ("detail",)) == strip(jm["result"], ("detail",))
    assert spans_by_level(tr.spans_path) == spans_by_level(jr.spans_path)
    pt, pj = prom(tr.metrics_prom), prom(jr.metrics_prom)
    assert pt["kspec_integrity_violations_total"] == pj["kspec_integrity_violations_total"] == "1"
    assert pt["kspec_integrity_checks_total"] == pj["kspec_integrity_checks_total"]


# --- profiler windows on the CPU ---------------------------------------------------


def test_xprof_window_and_profile_flag_on_the_cpu(tmp_path, capsys, monkeypatch):
    """KSPEC_OBS_XPROF=level:2-3 opens a torch.profiler window at the
    begin marker of levels 2 and 3, each closed when its level span ends,
    with the JAX package's events;
    `--profile DIR` writes the run's Chrome trace; neither leaves a
    profiler running."""
    _, tmodel = models("Kip101")
    monkeypatch.setenv("KSPEC_OBS_XPROF", "level:2-3")
    run = trunctx.RunContext(str(tmp_path / "r"))
    check(tmodel, device="cpu", run=run)
    events = [r for r in records(run.spans_path) if r["kind"] == "event"]
    assert [(e["event"], e.get("depth")) for e in events] == [
        ("xprof-start", 2), ("xprof-stop", None), ("xprof-start", 3), ("xprof-stop", None)]
    traces = sorted(os.listdir(os.path.join(run.dir, "xprof")))
    assert traces == [f"level-{d}-{os.getpid()}.pt.trace.json" for d in (2, 3)]
    for name in traces:
        with open(os.path.join(run.dir, "xprof", name)) as fh:
            assert json.load(fh)["traceEvents"]
    monkeypatch.delenv("KSPEC_OBS_XPROF")
    prof = tmp_path / "prof"
    assert tcli.main(["check", str(REPO / "configs" / "IdSequence.cfg"), "--cpu", "--json",
                      "--profile", str(prof), "--run-dir", str(tmp_path / "p")]) == 0
    rid = json.loads(capsys.readouterr().out)["run_id"]
    with open(prof / f"{rid}.pt.trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
