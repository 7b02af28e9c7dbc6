"""PyTorch port: the deterministic fleet simulation
(``resilience/simfleet/``), the raw-clock lint and ``durable_io``'s fault
hook, ``pytest -m simfleet``.

The JAX package's tests of it, run on the port's modules (the 500-seed
soak stays ``slow``, as JAX's is), then the port held against the JAX
package: ``run_digest`` for seeds 0-19 equals JAX's, the seeded lease
mutant is caught at the same seed and shrunk to JAX's minimal schedule,
and each seeded raw-clock mutant is found by both packages' lints.
"""

import json
import os
import shutil
import time

import pytest

import kafka_specification_tpu_torch.durable_io as dio
import kafka_specification_tpu_torch.service.queue as qmod
from kafka_specification_tpu_torch.analysis.clock_lint import (
    CLOCK_MIGRATED,
    lint_raw_clock,
)
from kafka_specification_tpu_torch.resilience import simfleet as sf
from kafka_specification_tpu_torch.service.queue import JobQueue
from kafka_specification_tpu_torch.service.router import Router, classify_host
from kafka_specification_tpu_torch.utils import clock as uclock
from kafka_specification_tpu_torch.cli import main as cli_main

pytestmark = pytest.mark.simfleet

ID_CFG = """
SPECIFICATION Spec
CONSTANTS
    MaxId = 6
INVARIANTS TypeOk
CHECK_DEADLOCK FALSE
"""


def _surface(record):
    return {k: record[k]
            for k in ("events", "verdicts", "violations", "drained")}


# --- determinism -----------------------------------------------------------


def test_same_seed_bit_identical():
    a = sf.run_seed(7)
    b = sf.run_seed(7)
    assert a["digest"] == b["digest"]
    # not just the hash: the full surface, byte for byte
    assert json.dumps(_surface(a), sort_keys=True) == \
        json.dumps(_surface(b), sort_keys=True)
    assert a["violations"] == [] and a["drained"]


def test_distinct_seeds_explore_distinct_schedules():
    a = sf.run_seed(1)
    b = sf.run_seed(2)
    assert a["digest"] != b["digest"]
    assert a["schedule"] != b["schedule"]


def test_replay_of_recorded_schedule_matches_generation():
    gen = sf.run_seed(11)
    rec, _ = sf.run_schedule(gen["schedule"], seed=11)
    assert rec["digest"] == gen["digest"]


def test_fast_soak_50_seeds_clean():
    out = sf.sweep_seeds(range(50))
    assert out["runs"] == 50 and out["clean"] == 50
    assert out["violating"] == []


@pytest.mark.slow
def test_soak_500_seeds_clean_under_budget():
    t0 = time.monotonic()
    out = sf.sweep_seeds(range(500))
    elapsed = time.monotonic() - t0
    assert out["runs"] == 500 and out["clean"] == 500, out["violating"][:1]
    assert elapsed < 120.0, f"soak took {elapsed:.1f}s (budget 120s)"


def test_coverage_guided_sweep_queues_derived_seeds():
    out = sf.sweep_seeds(range(3), coverage=True, max_extra=2)
    assert out["runs"] == 5  # 3 requested + 2 derived
    assert out["pair_coverage"] > 0


# --- the mutant loop: catch, shrink, bank, replay, stale -------------------


def _install_lease_mutant(monkeypatch):
    """THE seeded bug: every lease reads as orphaned, so janitors steal
    live claims — the exact regression the allowance exists to stop."""
    monkeypatch.setattr(
        JobQueue, "lease_orphaned",
        lambda self, jid, lease_ttl=None, skew_s=None: True)


def test_lease_mutant_caught_shrunk_and_replayed(tmp_path, monkeypatch):
    _install_lease_mutant(monkeypatch)
    hit = None
    for seed in range(20):
        rec = sf.run_seed(seed)
        steals = [v for v in rec["violations"]
                  if v["oracle"] == "live-claim-stolen"]
        if steals:
            hit = (seed, rec)
            break
    assert hit is not None, "mutant never caught in 20 seeds"
    seed, rec = hit
    small, srec = sf.shrink(rec["schedule"], sf.SimConfig(), seed,
                            "live-claim-stolen")
    assert len(small) <= 25, f"shrunk schedule still {len(small)} events"
    sv = next(v for v in srec["violations"]
              if v["oracle"] == "live-claim-stolen")
    path = str(tmp_path / "repro.json")
    sf.save_repro(path, seed, sf.SimConfig(), sv, small, srec,
                  shrunk_from=len(rec["schedule"]))
    repro = sf.load_repro(path)
    assert repro["schema"] == sf.REPRO_SCHEMA
    # under the mutant the banked repro reproduces, digest and all
    out = sf.replay_repro(repro)
    assert out["reproduced"] and out["digest_match"]
    # on the clean tree the same repro must read STALE, never green
    monkeypatch.undo()
    out = sf.replay_repro(repro)
    assert not out["reproduced"]


def test_shrink_rejects_non_reproducing_schedule():
    clean = sf.run_seed(3)
    assert clean["violations"] == []
    with pytest.raises(ValueError):
        sf.shrink(clean["schedule"], sf.SimConfig(), 3, "live-claim-stolen")


def test_load_repro_rejects_foreign_schema(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "kspec-sweep/1"}))
    with pytest.raises(ValueError):
        sf.load_repro(str(p))


# --- KSPEC_CLOCK_SKEW boundaries, exact to the millisecond -----------------
#
# Driven through the injectable clock: install a SimClock pinned at a
# known instant, plant stamps at threshold / threshold±1ms, and read
# the decision — no sleeping, no real-clock jitter in the assert.


@pytest.fixture
def simclock():
    clk = sf.SimClock()
    prev = uclock.install(clk)
    try:
        yield clk
    finally:
        uclock.install(prev)


def _plant_lease(q, jid, age):
    with open(q._lease_path(jid), "w") as fh:
        json.dump({"pid": 1, "token": "foreign-host",
                   "lease_unix": round(uclock.now() - age, 3)}, fh)


def test_queue_takeover_skew_boundary_exact_and_1ms(tmp_path, simclock):
    """lease_orphaned expiry: age >= ttl + skew takes over; 1ms inside
    the widened window the live foreigner keeps its claim."""
    q = JobQueue(str(tmp_path / "svc"), skew_s=5.0)
    jid = q.submit(ID_CFG, "IdSequence", kernel_source="hand")["job_id"]
    q.claim_pending()
    ttl, skew = 10.0, 5.0
    _plant_lease(q, jid, ttl + skew)          # exactly at the boundary
    assert q.lease_orphaned(jid, lease_ttl=ttl) is True
    _plant_lease(q, jid, ttl + skew - 0.001)  # 1ms fresh: pid 1 lives
    assert q.lease_orphaned(jid, lease_ttl=ttl) is False
    _plant_lease(q, jid, ttl + skew + 0.001)  # 1ms past: expired
    assert q.lease_orphaned(jid, lease_ttl=ttl) is True
    # an explicit per-call skew override wins over the instance's
    _plant_lease(q, jid, ttl + 1.0)
    assert q.lease_orphaned(jid, lease_ttl=ttl, skew_s=0.0) is True
    assert q.lease_orphaned(jid, lease_ttl=ttl, skew_s=2.0) is False


def _plant_hb(host_dir, unix):
    svc = os.path.join(str(host_dir), "service")
    os.makedirs(svc, exist_ok=True)
    with open(os.path.join(svc, "heartbeat.jsonl"), "a") as fh:
        fh.write(json.dumps({"kind": "service-heartbeat",
                             "unix": round(unix, 3)}) + "\n")


def test_router_liveness_skew_boundary_exact_and_1ms(tmp_path, simclock):
    """host_health/classify_host: hb_age <= dead_after + skew is alive;
    1ms past the widened window the host is dead."""
    dead_after, skew = 2.0, 5.0
    limit = dead_after + skew
    for i, (age, state) in enumerate([
        (limit, "ok"),            # exactly at the boundary: alive
        (limit - 0.001, "ok"),    # 1ms inside
        (limit + 0.001, "dead"),  # 1ms past
    ]):
        h = tmp_path / f"h{i}"
        JobQueue(str(h))
        r = Router(str(tmp_path / f"rt{i}"), hosts=[str(h)],
                   dead_after_s=dead_after, skew_s=skew)
        _plant_hb(h, uclock.now() - age)
        got = r.host_health(0)["state"]
        assert got == state, f"hb_age {age}: {got} != {state}"
    assert classify_host(True, False) == "dead"
    assert classify_host(True, True) == "ok"


# --- raw-clock lint --------------------------------------------------------


def test_clock_lint_zero_findings_on_tree():
    assert lint_raw_clock() == []


def test_clock_lint_covers_the_whole_migrated_plane():
    migrated = set(CLOCK_MIGRATED)
    for mod in ("kafka_specification_tpu_torch/service/queue.py",
                "kafka_specification_tpu_torch/service/router.py",
                "kafka_specification_tpu_torch/service/daemon.py",
                "kafka_specification_tpu_torch/resilience/heartbeat.py",
                "kafka_specification_tpu_torch/resilience/retry.py",
                "kafka_specification_tpu_torch/obs/fleettrace.py",
                "kafka_specification_tpu_torch/resilience/simfleet/kernel.py"):
        assert mod in migrated, f"{mod} missing from CLOCK_MIGRATED"


def _mutant_pkg(tmp_path, body):
    """A trimmed package copy holding one mutated migrated module."""
    root = tmp_path / "kafka_specification_tpu_torch"
    mod = root / "service" / "queue.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(body)
    return str(root)


def test_clock_lint_fires_on_seeded_raw_clock_mutant(tmp_path):
    root = _mutant_pkg(tmp_path, "import time\nstamp = time.time()\n")
    findings = lint_raw_clock(package_root=root)
    assert len(findings) == 1
    f = findings[0]
    assert f["path"].endswith("service/queue.py") and f["line"] == 2
    assert "utils/clock.py" in f["problem"]


def test_clock_lint_reasoned_allow_tag_suppresses(tmp_path):
    root = _mutant_pkg(
        tmp_path,
        "import time\n"
        "# kspec: allow(raw-clock) NTP probe must read the real clock\n"
        "stamp = time.time()\n")
    assert lint_raw_clock(package_root=root) == []


def test_clock_lint_bare_allow_tag_is_a_finding(tmp_path):
    root = _mutant_pkg(
        tmp_path,
        "import time\n"
        "# kspec: allow(raw-clock)\n"
        "stamp = time.time()\n")
    findings = lint_raw_clock(package_root=root)
    assert len(findings) == 1
    assert "no reason" in findings[0]["problem"]


def test_clock_lint_ignores_docstrings_and_comments(tmp_path):
    root = _mutant_pkg(
        tmp_path,
        '"""Uses time.time() internally (docs only)."""\n'
        "# time.sleep(1) would be wrong here\n"
        "x = 1\n")
    assert lint_raw_clock(package_root=root) == []


def test_cli_analyze_reports_raw_clock_high(tmp_path, monkeypatch, capsys):
    """The finding surfaces through `cli analyze` as HIGH raw-clock."""
    root = _mutant_pkg(tmp_path, "import time\nstamp = time.time()\n")
    import kafka_specification_tpu_torch.analysis.clock_lint as cl
    real = cl.lint_raw_clock
    monkeypatch.setattr(cl, "lint_raw_clock",
                        lambda package_root=None: real(package_root=root))
    rc = cli_main(["analyze", "--json"])
    rep = json.loads(capsys.readouterr().out)
    raw = [f for f in rep["findings"] if f["kind"] == "raw-clock"]
    assert rc == 1 and len(raw) == 1
    assert raw[0]["severity"] == "HIGH"


# --- durable_io fault hook -------------------------------------------------


def test_fault_hook_fails_op_before_effect(tmp_path):
    target = str(tmp_path / "x.json")

    def hook(op, path):
        if op == "write":
            raise OSError(5, "injected EIO", path)

    prev = dio.set_fault_hook(hook)
    try:
        with pytest.raises(OSError):
            dio.write_text(target, "{}")
        assert not os.path.exists(target)  # clean-fail: no effect landed
    finally:
        dio.set_fault_hook(prev)
    dio.write_text(target, "{}")  # hook gone: op lands
    assert os.path.exists(target)


# --- cli surface -----------------------------------------------------------


def test_cli_simfleet_run_clean_seeds(tmp_path, capsys):
    rc = cli_main(["simfleet", "run", "--seeds", "3",
                   "--out", str(tmp_path / "repros"), "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["ok"]
    assert rep["schema"] == "kspec-simfleet-sweep/1"
    assert rep["runs"] == 3 and rep["clean"] == 3


def test_cli_simfleet_replay_reports_stale_on_clean_tree(
        tmp_path, monkeypatch, capsys):
    _install_lease_mutant(monkeypatch)
    out_dir = str(tmp_path / "repros")
    rc = cli_main(["simfleet", "run", "--seeds", "4",
                   "--out", out_dir, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1 and rep["violations"]
    banked = rep["violations"][0]
    assert banked["events"] <= 25
    path = banked["path"]
    # still mutated: the repro reproduces and exits 0
    rc = cli_main(["simfleet", "replay", path, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["reproduced"]
    # clean tree: STALE, exit 2
    monkeypatch.undo()
    rc = cli_main(["simfleet", "replay", path, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 2 and not rep["reproduced"]


def test_cli_simfleet_replay_trace_renders_waterfall(
        tmp_path, monkeypatch, capsys):
    _install_lease_mutant(monkeypatch)
    out_dir = str(tmp_path / "repros")
    rc = cli_main(["simfleet", "run", "--seeds", "4",
                   "--out", out_dir, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1
    path = rep["violations"][0]["path"]
    rc = cli_main(["simfleet", "replay", path, "--trace"])
    out = capsys.readouterr().out
    assert rc == 0 and "REPRODUCED" in out
    # the same waterfall `cli trace` renders: a Trace header plus spans
    assert "Trace tr-" in out and "job-submit" in out


# --- real-clock default path unchanged -------------------------------------


def test_system_clock_still_the_default():
    """No sim installed: the shim reads the real clock (the production
    path the service's e2e tests exercise unmodified)."""
    assert isinstance(uclock.get(), uclock.SystemClock)
    before = time.time()
    got = uclock.now()
    assert abs(got - before) < 5.0


# --- the port against the JAX package --------------------------------------

from kafka_specification_tpu.analysis.clock_lint import lint_raw_clock as jlint  # noqa: E402
from kafka_specification_tpu.resilience import simfleet as jsf  # noqa: E402
from kafka_specification_tpu.service.queue import JobQueue as JJobQueue  # noqa: E402
from kafka_specification_tpu_torch.resilience.simfleet.kernel import run_digest  # noqa: E402

#: run_digest of seeds 0-4 in either package (pinned on the card too)
DIGESTS = (
    "2da43a890e04bce234b4e6fb98b7eefe0913e1d07d4e4092316e70e81b670489",
    "9c660e2b3b398f9e070bdc2d5d58979cc480ca447388ed31cb039d5495786965",
    "46f38e1413c6720b6a14c13d734974d4aff625f300fc92eed57754cf57e7b386",
    "274c261c5e18cb5a72b907626249d6c8658d1ddbb3fa1db3602e7fbb8748c55d",
    "adb700fe0dbe88f31b55ce3c6626a5656a93aa73c6750718ef53d76068d51d8a",
)


def test_run_digest_equals_jax_for_seeds_0_to_19():
    for seed in range(20):
        rec, jrec = sf.run_seed(seed), jsf.run_seed(seed)
        assert run_digest(rec) == rec["digest"]
        assert rec["digest"] == jrec["digest"], seed
        assert _surface(rec) == _surface(jrec)
        if seed < len(DIGESTS):
            assert rec["digest"] == DIGESTS[seed]


def test_lease_mutant_shrinks_to_jax_schedule(monkeypatch):
    """Both packages, each under the seeded lease mutant: caught at the
    same first seed, shrunk to the same minimal schedule and digest."""
    _install_lease_mutant(monkeypatch)
    monkeypatch.setattr(JJobQueue, "lease_orphaned",
                        lambda self, jid, lease_ttl=None, skew_s=None: True)
    got = {}
    for name, mod in (("port", sf), ("jax", jsf)):
        seed = next(s for s in range(20) if any(
            v["oracle"] == "live-claim-stolen" for v in mod.run_seed(s)["violations"]))
        rec = mod.run_seed(seed)
        small, srec = mod.shrink(rec["schedule"], mod.SimConfig(), seed, "live-claim-stolen")
        got[name] = (seed, rec["digest"], small, srec["digest"], srec["violations"])
    assert got["port"] == got["jax"]
    assert len(got["port"][2]) <= 25


def test_clock_lints_of_both_packages_find_the_seeded_mutants(tmp_path):
    """A raw time.sleep in a migrated module, a `from time import` and a
    bare allow tag: both lints find the same three sites (each on a
    package copy of its own name), and neither finds one on its tree."""
    body = ("import time\n"
            "from time import monotonic\n"
            "def f():\n"
            "    time.sleep(1)\n"
            "    # kspec: allow(raw-clock)\n"
            "    return time.time()\n")
    found = {}
    for name, lint in (("kafka_specification_tpu_torch", lint_raw_clock),
                       ("kafka_specification_tpu", jlint)):
        mod = tmp_path / name / name / "service" / "router.py"
        mod.parent.mkdir(parents=True)
        mod.write_text(body)
        found[name] = [(f["line"], f["problem"]) for f in lint(str(mod.parents[1]))]
    assert found["kafka_specification_tpu_torch"] == found["kafka_specification_tpu"]
    assert [line for line, _ in found["kafka_specification_tpu"]] == [2, 4, 6]
    assert lint_raw_clock() == [] and jlint() == []
