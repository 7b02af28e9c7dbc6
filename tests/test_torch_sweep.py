"""PyTorch port: coverage sweeps (sweep/: lattice, cost, portfolio, bisect;
`cli sweep`) against the JAX package's, on the CPU.  `plan_sweep` equals
JAX's record for record (point ids, synthesized configs, vacuous
findings, predictions) and never initialises CUDA; a port sweep's manifest
equals a JAX sweep's row for row (ids, nonces and clocks aside), each
verdict equal to a solo check, and a repeat sweep hits the state cache on
every point; a crash-resumed sweep runs every point exactly once; the
frontiers of `bisect` equal JAX's; `cli sweep` and `report` give JAX's
exit codes and text; planning without torch fails loudly (the torch-free
readers are held in tests/test_torch_imports.py).  The daemons run in
process (SweepConfig.drive), as the JAX package's own tests run them."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kafka_specification_tpu.service.daemon import Daemon as JDaemon
from kafka_specification_tpu.service.daemon import ServeConfig as JServeConfig
from kafka_specification_tpu.sweep import bisect as jbisect
from kafka_specification_tpu.sweep import lattice as jlattice
from kafka_specification_tpu.sweep import portfolio as jportfolio
from kafka_specification_tpu.utils import cli as jcli
from kafka_specification_tpu_torch import check, cli
from kafka_specification_tpu_torch.models import id_sequence, variants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
from kafka_specification_tpu_torch.service.verdict import verdict_from_result
from kafka_specification_tpu_torch.sweep import (
    SweepConfig,
    bisect_line,
    enumerate_points,
    job_id_for,
    load_lattice,
    load_manifest,
    plan_sweep,
    refine_frontier,
    run_sweep,
)
from kafka_specification_tpu_torch.sweep import bisect as tbisect
from kafka_specification_tpu_torch.sweep import lattice as tlattice
from kafka_specification_tpu_torch.utils.cfg import parse_cfg, resolved_invariants
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.sweep

REPO = Path(__file__).resolve().parents[1]
ID_CFG = """
SPECIFICATION Spec
CONSTANTS
    MaxId = 6
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""
TTW_CFG_WEAK = """
SPECIFICATION Spec
CONSTANTS
    Replicas = {b1, b2}
    LogSize = 2
    MaxRecords = 1
    MaxLeaderEpoch = 1
INVARIANTS TypeOk WeakIsr
CHECK_DEADLOCK FALSE
"""
FRL_CFG = open(REPO / "configs" / "FiniteReplicatedLog.cfg").read()
KIP320_CFG = open(REPO / "configs" / "Kip320.cfg").read()
THW = "KafkaTruncateToHighWatermark"


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    monkeypatch.delenv("KSPEC_STATE_CACHE_DIR", raising=False)


def e2e_lattice() -> dict:
    return {
        "schema": "kspec-sweep-lattice/1", "name": "e2e", "on_vacuous": "skip",
        "sheets": [
            {"module": THW, "cfg_text": TTW_CFG_WEAK,
             "axes": [{"name": "max_depth", "kind": "bound", "values": [2, 8]}]},
            {"module": "IdSequence", "cfg_text": ID_CFG,
             "axes": [{"name": "MaxId", "values": [4, 6]}]},
        ],
    }


def plan_lattice() -> dict:
    """FRL Replicas x LogSize, a Kip320 sheet with max_depth 8, 12, null, and
    a TruncateToHW sheet whose MaxRecords 0 point is statically vacuous."""
    return {
        "schema": "kspec-sweep-lattice/1", "name": "plan", "on_vacuous": "skip",
        "sheets": [
            {"module": "FiniteReplicatedLog", "cfg_text": FRL_CFG,
             "axes": [{"name": "Replicas", "values": [2, 3]},
                      {"name": "LogSize", "values": [1, 2]}]},
            {"module": "Kip320", "cfg_text": KIP320_CFG,
             "axes": [{"name": "max_depth", "kind": "bound", "values": [8, 12, None]}]},
            {"module": THW, "cfg_text": TTW_CFG_WEAK,
             "axes": [{"name": "MaxRecords", "values": [0, 1]}]},
        ],
    }


def plan_record(plan) -> dict:
    return {
        "points": [p.record() for p in plan["points"]],
        "cfg_texts": [p.cfg_text for p in plan["points"]],
        "vacuous": {p.point_id: p.vacuous for p in plan["points"]},
        "runnable": [p.point_id for p in plan["runnable"]],
        "deferred": [p.point_id for p in plan["deferred"]],
        "skipped": [p.point_id for p in plan["skipped"]],
        "predictions": plan["predictions"],
        "model": plan["model"].to_dict(),
    }


@pytest.mark.parametrize("on_vacuous", ["skip", "defer", "run"])
def test_plan_sweep_equals_jax_record_for_record(tmp_path, on_vacuous):
    lat = dict(plan_lattice(), on_vacuous=on_vacuous)
    svc = str(tmp_path / "svc")
    t = plan_sweep(load_lattice(lat), SweepConfig(sweep_dir=".", service_dir=svc))
    j = jportfolio.plan_sweep(jlattice.load_lattice(lat),
                              jportfolio.SweepConfig(sweep_dir=".", service_dir=svc))
    assert plan_record(t) == plan_record(j)
    assert len(t["points"]) == 9
    vac = [p for p in t["points"] if p.vacuous]
    assert [dict(p.coords) for p in vac] == [{"MaxRecords": 0}]
    assert vac[0].vacuous[0]["target"] == "action:LeaderWrite"
    # the vacuity pass runs on CPU tensors: planning never touches the card
    assert not torch.cuda.is_initialized()


def test_point_keys_are_the_state_cache_keys_of_jax():
    t = enumerate_points(load_lattice(plan_lattice()))
    j = jlattice.enumerate_points(jlattice.load_lattice(plan_lattice()))
    assert [p.point_id for p in t] == [p.point_id for p in j]
    assert [(p.key.base_digest(), p.key.bounds_name()) for p in t] == \
        [(p.key.base_digest(), p.key.bounds_name()) for p in j]
    assert tlattice.vacuous_findings(THW, t[-2].cfg_text) == \
        jlattice.vacuous_findings(THW, j[-2].cfg_text)


def solo_verdict(point) -> dict:
    if point.module == "IdSequence":
        model = id_sequence.make_model(dict(point.coords).get("MaxId", 6))
    else:
        invs = resolved_invariants(point.module, parse_cfg(point.cfg_text))
        model = variants.make_model(point.module, Config(2, 2, 1, 1), invs)
    res = check(model, max_depth=point.max_depth, max_states=point.max_states,
                min_bucket=32, device="cpu")
    return verdict_from_result(res)


_VOLATILE = {"job_id", "seconds", "states_per_sec", "sweep_id", "created_unix",
             "updated_unix", "published_unix", "at", "unix"}


def stable(obj):
    if isinstance(obj, dict):
        return {k: stable(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [stable(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """The e2e lattice swept twice by each package against its own
    in-process daemon: -> {side: (first manifest, repeat manifest, dirs)}."""
    root = tmp_path_factory.mktemp("swept")
    out = {}
    lat = e2e_lattice()
    for side, daemon, cfg, load, run, scfg in (
            ("t", Daemon, lambda s: ServeConfig(s, device="cpu", linger_s=0.0, min_bucket=32),
             load_lattice, run_sweep, SweepConfig),
            ("j", JDaemon, lambda s: JServeConfig(service_dir=s, linger_s=0.0, min_bucket=32),
             jlattice.load_lattice, jportfolio.run_sweep, jportfolio.SweepConfig)):
        svc = str(root / side / "svc")
        d = daemon(cfg(svc))
        recs = [run(load(lat), scfg(sweep_dir=str(root / side / f"sw{i}"), service_dir=svc,
                                    drive=d.drain_once, wait_timeout_s=300.0))
                for i in (1, 2)]
        out[side] = (recs[0], recs[1], str(root / side))
    return out


def test_sweep_manifest_equals_jax_row_for_row(swept):
    t1, t2, troot = swept["t"]
    j1, j2, _ = swept["j"]
    assert stable(t1) == stable(j1)
    assert stable(t2) == stable(j2)
    rows = list(t1["points"].values())
    assert [r["status"] for r in rows] == ["done"] * 4
    for p in enumerate_points(load_lattice(e2e_lattice())):
        solo = solo_verdict(p)
        v = t1["points"][p.point_id]["verdict"]
        for k in ("distinct_states", "diameter", "violation", "exit_code"):
            assert v[k] == solo[k], (p.point_id, k)
    (viol,) = [r for r in rows if (r["verdict"] or {}).get("violation")]
    assert viol["verdict"]["violation"]["invariant"] == "WeakIsr"
    # a repeat sweep: every point a verified state-cache hit, no engine run
    assert [(r.get("cache") or {}).get("state_cache") for r in t2["points"].values()] == [
        "hit"] * 4
    for r in t2["points"].values():
        assert r["verdict"]["distinct_states"] == t1["points"][r["point_id"]]["verdict"][
            "distinct_states"]


def test_sweep_report_and_bisect_equal_jax(swept, capsys):
    """`sweep report`, `report <sweep dir>` and the frontier, read by both
    packages from the port's sweep directory and from JAX's."""
    from kafka_specification_tpu.obs import report as jreport
    from kafka_specification_tpu_torch.obs import report as treport

    for side in ("t", "j"):
        sw = os.path.join(swept[side][2], "sw1")
        td, jd = treport.sweep_report_data(sw), jreport.sweep_report_data(sw)
        assert td == jd and td["counts"]["violations"] == 1
        assert treport.render_sweep_report(td) == jreport.render_sweep_report(jd)
        man = load_manifest(sw)
        assert tbisect.frontier_from_manifest(man) == jbisect.frontier_from_manifest(man)
        assert refine_frontier(man, lambda c: {}) == jbisect.refine_frontier(man, lambda c: {})
        (fr,) = td["frontiers"]["WeakIsr"]
        assert dict(fr["coords"]) == {"max_depth": 8}
        outs = []
        for main in (cli.main, jcli.main):
            rcs = [main(["report", sw]), main(["sweep", "report", sw, "--json"]),
                   main(["sweep", "bisect", sw]), main(["sweep", "bisect", sw, "--json"])]
            outs.append((rcs, capsys.readouterr()))
        assert outs[0][0] == outs[1][0] == [0, 0, 0, 0]
        assert outs[0][1].out == outs[1][1].out
        assert "minimal violating configs — WeakIsr" in outs[0][1].out


def synthetic_manifest(statuses: dict) -> dict:
    points = {}
    for n, viol in statuses.items():
        points[f"p{n}"] = {
            "point_id": f"p{n}", "coords": [["N", n]], "status": "done",
            "verdict": {"violation": viol, "distinct_states": 10 * n,
                        "exit_code": 1 if viol else 0},
        }
    return {"schema": "kspec-sweep/1", "sweep_id": "syn", "name": "syn",
            "lattice": {"sheets": [{"axes": [
                {"name": "N", "kind": "constant", "values": [1, 2, 3, 4]}]}]},
            "points": points}


@pytest.mark.parametrize("statuses,frontier", [
    ({4: {"invariant": "Inv", "depth": 2, "trace_len": 3}}, 1),
    ({4: {"invariant": "Inv", "depth": 2, "trace_len": 3}, 3: None}, 3),
    ({3: {"invariant": "Inv", "depth": 1, "trace_len": 2},
      4: {"invariant": "Inv", "depth": 2, "trace_len": 3}}, 1),
], ids=["probe-down", "witnessed-row", "two-claims"])
def test_refine_frontier_equals_jax(statuses, frontier):
    """The witness pass with a runner that violates from N=2 up: the probes,
    demotions and frontier equal JAX's."""

    def runner_for(probed):
        def runner(coords):
            (n,) = [v for k, v in coords if k == "N"]
            probed.append(n)
            if n >= 2:
                return {"violation": {"invariant": "Inv", "depth": 1, "trace_len": 2},
                        "distinct_states": 10 * n}
            return {"violation": None, "distinct_states": 10}
        return runner

    tp, jp = [], []
    t = refine_frontier(synthetic_manifest(statuses), runner_for(tp))
    j = jbisect.refine_frontier(synthetic_manifest(statuses), runner_for(jp))
    assert (t, tp) == (j, jp)
    assert [r["_indices"] for r in t["Inv"]["frontier"]] == [[["N", frontier]]]
    for values in ([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3], []):
        for cut in (0, 3, 6, 99):
            assert bisect_line(values, lambda v: v >= cut) == \
                jbisect.bisect_line(values, lambda v: v >= cut)


def test_run_sweep_crash_resume_exactly_once(tmp_path):
    """A sweep that 'crashes' after submitting (no daemon, a zero wait) is
    resumed from its directory: the same sweep id and deterministic job
    ids, every point run exactly once."""
    svc, sw = str(tmp_path / "svc"), str(tmp_path / "sweep")
    lat = load_lattice({"schema": "kspec-sweep-lattice/1", "name": "resume",
                        "module": "IdSequence", "cfg_text": ID_CFG,
                        "axes": [{"name": "MaxId", "values": [4, 6]}]})
    rec1 = run_sweep(lat, SweepConfig(sweep_dir=sw, service_dir=svc, wait_timeout_s=0.0))
    assert [r["status"] for r in rec1["points"].values()] == ["submitted"] * 2
    ids = {r["job_id"] for r in rec1["points"].values()}
    assert ids == {job_id_for(rec1["sweep_id"], pid) for pid in rec1["points"]}
    d = Daemon(ServeConfig(svc, device="cpu", linger_s=0.0, min_bucket=32))
    rec2 = run_sweep(lat, SweepConfig(sweep_dir=sw, service_dir=svc, drive=d.drain_once,
                                      wait_timeout_s=120.0))
    assert rec2["sweep_id"] == rec1["sweep_id"]
    assert [r["status"] for r in rec2["points"].values()] == ["done"] * 2
    assert {r["job_id"] for r in rec2["points"].values()} == ids
    assert sorted(f[:-5] for f in os.listdir(os.path.join(svc, "results"))
                  if f.endswith(".json")) == sorted(ids)
    assert [r["verdict"]["distinct_states"] for r in rec2["points"].values()] == [6, 8]


def _cli_sweep(main, root, capsys):
    lat = root / "lat.json"
    lat.write_text(json.dumps({"schema": "kspec-sweep-lattice/1", "name": "cli",
                               "module": THW, "cfg_text": TTW_CFG_WEAK,
                               "axes": [{"name": "MaxRecords", "values": [0, 1]}]}))
    bad = root / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    svc = str(root / "svc")
    out = []
    for args in (["sweep", "plan", str(lat), "--service-dir", svc],
                 ["sweep", "plan", str(lat), "--json", "--service-dir", svc],
                 ["sweep", "plan", str(bad)], ["sweep", "plan", str(root / "missing.json")],
                 ["sweep", "run", str(lat), "--sweep-dir", str(root / "sw"), "--service-dir",
                  svc, "--timeout", "0"],
                 ["sweep", "report", str(root / "nope")],
                 ["sweep", "bisect", str(root / "nope")]):
        rc = main(args)
        o, e = capsys.readouterr()
        out.append((rc, o.replace(str(root), "<root>"),
                    (e.strip().splitlines() or [""])[-1].replace(str(root), "<root>")))
    return out


def test_cli_sweep_exit_codes_and_text_equal_jax(tmp_path, capsys):
    """`sweep plan` (text and --json), a bad and a missing lattice (exit
    2), `sweep run` with nobody serving (exit 75: points left submitted),
    `sweep report`/`bisect` of a missing directory (exit 2): JAX's codes,
    and JAX's text where no nonce or clock is in it."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = _cli_sweep(cli.main, tmp_path / "t", capsys)
    j = _cli_sweep(jcli.main, tmp_path / "j", capsys)
    assert [x[0] for x in t] == [x[0] for x in j] == [0, 0, 2, 2, 75, 2, 2]
    for i in (0, 1, 2, 3):
        assert t[i] == j[i], i
    assert "1 skipped as statically vacuous" in t[0][1]


def test_planning_without_torch_fails_loudly(tmp_path):
    """The vacuity pass needs torch: without it `sweep plan` raises instead
    of planning a manifest with no vacuity skip (which would differ from
    JAX's)."""
    lat = tmp_path / "lat.json"
    lat.write_text(json.dumps({"schema": "kspec-sweep-lattice/1", "name": "nt",
                               "module": "IdSequence", "cfg_text": ID_CFG, "axes": []}))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["torch"] = None
        from kafka_specification_tpu_torch import cli
        cli.main(["sweep", "plan", {str(lat)!r}, "--service-dir", {str(tmp_path / "svc")!r}])
        """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "import of torch halted" in out.stderr
