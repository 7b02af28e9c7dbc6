"""PyTorch port: the fleet half of the supervisor (resilience/supervisor.py:
FleetConfig, supervise_fleet) and the runner's fleet and preset modes
(scripts/torch_resilient_run.py --fleet / --devices-per-proc / --preset
prod464, scripts/torch_run_product.py) against the JAX package's.

The scripted fleets of JAX's tests (children that only append heartbeat
lines and exit) run under both packages' supervisors; the event streams
agree kind for kind.  The port's children read torchrun's variables
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) where JAX's read
JAX_PROCESS_ID and friends.  End to end: a two-process gloo fleet of the
port's sharded engine on the disk tier, one process crashed by a
shard-scoped fault, torn down, restarted and resumed to JAX's result,
trace value for value."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from kafka_specification_tpu.models import variants as jvariants
from kafka_specification_tpu.models.kafka_replication import Config as JConfig
from kafka_specification_tpu.parallel import sharded as jsharded
from kafka_specification_tpu.resilience import supervisor as jsup
from kafka_specification_tpu_torch.resilience import supervisor as tsup
from kafka_specification_tpu_torch.resilience.resources import EXIT_RESOURCE_EXHAUSTED

pytestmark = pytest.mark.fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the scripted child of JAX's fleet test; RANK_VAR names the variable that
# carries the process index in each package
_FLEET_CHILD = """
import json, os, sys, time
hb_dir = os.environ["KSPEC_SHARD_HEARTBEAT_DIR"]
pid = os.environ[RANK_VAR]
os.makedirs(hb_dir, exist_ok=True)
marker = os.path.join(sys.argv[1], "crashed-once")
for depth in range(4):
    with open(os.path.join(hb_dir, f"proc{pid}.jsonl"), "a") as fh:
        fh.write(json.dumps({"kind": "shard-heartbeat", "proc": int(pid),
                             "pid": os.getpid(), "depth": depth,
                             "unix": time.time()}) + "\\n")
    if pid == "1" and depth == 2 and not os.path.exists(marker):
        open(marker, "w").close()
        sys.exit(7)  # shard 1 dies mid-run, exactly once
    time.sleep(0.05)
"""
RANK_VAR = {tsup: "RANK", jsup: "JAX_PROCESS_ID"}


def events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def kinds(path):
    return [e["event"] for e in events(path)]


@pytest.mark.parametrize("sup", [tsup, jsup], ids=["port", "jax"])
def test_fleet_supervisor_restarts_after_shard_death(sup, tmp_path):
    """One process of the fleet dies: the whole fleet is torn down and
    restarted, the second attempt completes, and the event log attributes
    the death to the process; the port's events are JAX's, kind for kind
    (the JAX case runs the same child under JAX's supervisor)."""
    ev = str(tmp_path / "events.jsonl")
    child = f"RANK_VAR = {RANK_VAR[sup]!r}\n" + _FLEET_CHILD
    cfg = sup.FleetConfig(
        cmd=[sys.executable, "-c", child, str(tmp_path)],
        num_processes=3, events=ev, heartbeat_dir=str(tmp_path / "shards"),
        log_dir=str(tmp_path / "logs"), stall_timeout=60.0, max_restarts=2,
        backoff_base=0.05, backoff_cap=0.1)
    assert sup.supervise_fleet(cfg) == 0
    got = events(ev)
    ks = [e["event"] for e in got]
    assert ks == ["fleet-start", "shard-exit", "fleet-teardown", "restart", "fleet-start",
                  "fleet-teardown", "fleet-complete"]
    dead = next(e for e in got if e["event"] == "shard-exit")
    assert dead["proc"] == 1 and dead["rc"] == 7
    assert all(e["kind"] == "supervisor" for e in got)
    assert any("proc2" in name for name in os.listdir(str(tmp_path / "logs")))


@pytest.mark.parametrize("sup", [tsup, jsup], ids=["port", "jax"])
def test_fleet_supervisor_stall_kill_and_give_up(sup, tmp_path):
    """A fleet that stops heartbeating is stall-killed; the restart budget
    bounds the attempts (non-zero exit, give-up event), as in JAX's."""
    ev = str(tmp_path / "events.jsonl")
    cfg = sup.FleetConfig(
        cmd=[sys.executable, "-c", "import time; time.sleep(600)"], num_processes=2,
        events=ev, heartbeat_dir=str(tmp_path / "shards"), stall_timeout=0.5, max_restarts=1,
        backoff_base=0.05, backoff_cap=0.1, poll=0.1, term_grace=2.0)
    assert sup.supervise_fleet(cfg) != 0
    ks = kinds(ev)
    assert ks.count("shard-stall") == 2 and ks[-1] == "fleet-give-up"
    assert ks == ["fleet-start", "shard-stall", "fleet-teardown", "restart", "fleet-start",
                  "shard-stall", "fleet-teardown", "fleet-give-up"]


@pytest.mark.parametrize("sup", [tsup, jsup], ids=["port", "jax"])
def test_fleet_supervisor_classifies_resource_exit(sup, tmp_path):
    """One process exiting 75 while its peers wedge: a resource verdict,
    the fleet torn down once and never restarted, as in JAX's."""
    child = (f"import os, sys, time\nif os.environ[{RANK_VAR[sup]!r}] == '0':\n"
             "    sys.exit(75)\ntime.sleep(60)\n")
    ev = tmp_path / "events.jsonl"
    cfg = sup.FleetConfig(
        cmd=[sys.executable, "-c", child], num_processes=3, events=str(ev), stall_timeout=30.0,
        max_restarts=3, backoff_base=0.01, backoff_cap=0.02, term_grace=2.0)
    assert sup.supervise_fleet(cfg) == EXIT_RESOURCE_EXHAUSTED
    ks = kinds(ev)
    assert "shard-resource-exhausted" in ks and "resource-verdict" in ks
    assert "restart" not in ks and ks.count("fleet-start") == 1


def test_child_environment_is_torchruns(tmp_path):
    """The port's child gets torchrun's variables (which parallel/multihost.py
    reads) where JAX's gets its coordinator's, the same heartbeat
    directory, and devices_per_proc as the CPU mesh's shards a process."""
    kw = dict(cmd=["x"], num_processes=4, heartbeat_dir=str(tmp_path), env={"KEEP": "1"},
              devices_per_proc=2)
    env = tsup._child_env(tsup.FleetConfig(**kw), 3, 4321)
    jenv = jsup._child_env(jsup.FleetConfig(**kw), 3, 4321)
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "KSPEC_CPU_SHARDS_PER_PROC")} == {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "4321", "WORLD_SIZE": "4", "RANK": "3",
        "LOCAL_RANK": "3", "KSPEC_CPU_SHARDS_PER_PROC": "2"}
    assert jenv["JAX_COORDINATOR_ADDRESS"] == "127.0.0.1:4321"
    assert (jenv["JAX_NUM_PROCESSES"], jenv["JAX_PROCESS_ID"]) == ("4", "3")
    for k in ("KEEP", "KSPEC_SHARD_HEARTBEAT_DIR"):
        assert env[k] == jenv[k]
    assert "JAX_PROCESS_ID" not in env and "XLA_FLAGS" not in env


def test_cpu_mesh_takes_its_shards_per_process(monkeypatch):
    from kafka_specification_tpu_torch.parallel import ShardMesh

    assert ShardMesh.default("cpu").size == 1
    monkeypatch.setenv("KSPEC_CPU_SHARDS_PER_PROC", "3")
    m = ShardMesh.default("cpu")
    assert (m.size, m.my_shards) == (3, [0, 1, 2])


_WORKER = """
import json, os, sys
from kafka_specification_tpu_torch.parallel.multihost import init_distributed
from kafka_specification_tpu_torch.parallel import check_sharded
from kafka_specification_tpu_torch.models import variants
from kafka_specification_tpu_torch.models.kafka_replication import Config
ck, out = sys.argv[1], sys.argv[2]
info = init_distributed("cpu")
m = variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1),
                        ("TypeOk", "WeakIsr"))
res = check_sharded(m, min_bucket=32, checkpoint_dir=ck, mem_budget=1024, device="cpu")
if info["process_id"] == 0:
    with open(out, "w") as fh:
        json.dump({"total": res.total, "levels": res.levels, "devices": res.stats["devices"],
                   "inv": res.violation.invariant, "depth": res.violation.depth,
                   "trace": repr(res.violation.trace),
                   "sizes": res.stats["host_fpset_sizes"]}, fh)
"""


def test_fleet_of_two_gloo_processes_restarts_to_jax_result(tmp_path):
    """supervise_fleet over two gloo processes of two shards each (D = 4,
    devices_per_proc=2) on the disk tier: crash@shard2:level:4 kills the
    process owning shard 2, the fleet is torn down and restarted, both
    processes resume from the generation they agree on (the per-host
    parts carry their shards' run manifests), and the result is JAX's at
    D = 4, the counterexample's trace value for value."""
    golden = jsharded.check_sharded(
        jvariants.make_model("KafkaTruncateToHighWatermark", JConfig(2, 2, 1, 1),
                             ("TypeOk", "WeakIsr")),
        mesh=Mesh(np.array(jax.devices()[:4]), ("d",)), min_bucket=32)
    out = str(tmp_path / "result.json")
    env = dict(os.environ, PYTHONPATH=REPO, KSPEC_FAULT="crash@shard2:level:4",
               KSPEC_SPILL_RUNS_PER_MERGE="2")
    ev = str(tmp_path / "events.jsonl")
    cfg = tsup.FleetConfig(
        cmd=[sys.executable, "-c", _WORKER, str(tmp_path / "ck"), out], num_processes=2,
        devices_per_proc=2, events=ev, heartbeat_dir=str(tmp_path / "shards"),
        log_dir=str(tmp_path / "logs"), stall_timeout=300.0, max_restarts=2,
        backoff_base=0.05, backoff_cap=0.1, env=env)
    rc = tsup.supervise_fleet(cfg)
    logs = {n: open(os.path.join(tmp_path, "logs", n), errors="replace").read()[-2000:]
            for n in sorted(os.listdir(tmp_path / "logs"))}
    assert rc == 0, logs
    got = events(ev)
    ks = [e["event"] for e in got]
    assert ks.count("fleet-start") == 2 and ks[-1] == "fleet-complete"
    # shards 2 and 3 live on process 1, which the fault crashes; its gloo
    # peer then fails in its next collective, so either exit may be seen
    # first
    assert next(e for e in got if e["event"] == "shard-exit")["proc"] in (0, 1)
    assert "InjectedCrash" in logs["attempt-01-proc1.log"]
    assert "InjectedCrash" not in logs["attempt-01-proc0.log"]
    res = json.loads(open(out).read())
    assert (res["total"], res["levels"], res["devices"]) == (golden.total, golden.levels, 4)
    assert (res["inv"], res["depth"]) == (golden.violation.invariant, golden.violation.depth)
    assert res["trace"] == repr(golden.violation.trace)
    # each process restored its own shards' tiered sets from its part file
    assert res["sizes"][2:] == [None, None] and all(s for s in res["sizes"][:2])
    beats = [json.loads(line) for line in open(tmp_path / "shards" / "proc1.jsonl")]
    assert {tuple(b["shards"]) for b in beats} == {(2, 3)}


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(mod, argv, monkeypatch, attr):
    got = {}
    monkeypatch.setattr(mod, attr, lambda cfg: got.setdefault("cfg", cfg) and 0)
    assert mod.main(argv) == 0
    return got["cfg"]


def test_runner_preset_prod464_builds_jax_environment_and_the_port_product(monkeypatch,
                                                                          tmp_path):
    """--preset prod464 exports the JAX runner's environment pins (the
    checkpoint, the adaptive-compact pin, the heartbeat as the child's
    stats stream, the budget and spill directory) and runs the port's
    product script on the mixed464 base, a single-device check() on the
    host backend."""
    for k in ("KSPEC_PROD_CKPT", "KSPEC_PROD_STATS", "KSPEC_PROD_MEMBUDGET",
              "KSPEC_PROD_SPILL", "KSPEC_ADAPTIVE_COMPACT"):
        monkeypatch.delenv(k, raising=False)
    port = _load_script(os.path.join(REPO, "scripts", "torch_resilient_run.py"), "t_runner")
    jaxr = _load_script(os.path.join(REPO, "scripts", "resilient_run.py"), "j_runner")
    cfgs = []
    for mod, run in ((port, "port"), (jaxr, "jax")):
        argv = ["--preset", "prod464", "--run-dir", str(tmp_path / run), "--mem-budget", "8G",
                "--spill-dir", str(tmp_path / "spill"), "--heartbeat", str(tmp_path / "hb")]
        cfgs.append(_captured(mod, argv, monkeypatch, "supervise"))
    cfg, jcfg = cfgs
    pins = ("KSPEC_PROD_CKPT", "KSPEC_ADAPTIVE_COMPACT", "KSPEC_PROD_STATS",
            "KSPEC_PROD_MEMBUDGET", "KSPEC_PROD_SPILL")
    assert {k: cfg.env[k] for k in pins} == {k: jcfg.env[k] for k in pins}
    assert cfg.env["KSPEC_PROD_CKPT"] == os.path.join(REPO, ".prod464_ckpt")
    assert cfg.heartbeat == jcfg.heartbeat == cfg.env["KSPEC_PROD_STATS"] == str(tmp_path / "hb")
    assert cfg.cmd == [sys.executable, os.path.join(REPO, "scripts", "torch_run_product.py"),
                       "--base", "mixed464"]
    assert jcfg.cmd[1:] == [os.path.join(REPO, "scripts", "run_product_tiny3.py"), "--base",
                            "mixed464"]
    product = _load_script(os.path.join(REPO, "scripts", "torch_run_product.py"), "t_product")
    model, golden, workload = product.build("tiny", 1)
    assert golden == 277 and model.spec.num_lanes == tkip_lanes()
    with pytest.raises(SystemExit):
        port.main(["--preset", "prod464", "--run-dir", str(tmp_path / "x"), "--", "echo"])


def tkip_lanes():
    from kafka_specification_tpu_torch.models import kip320
    from kafka_specification_tpu_torch.models.kafka_replication import Config

    return kip320.make_model(Config(2, 2, 1, 1)).spec.num_lanes


def test_runner_fleet_mode_builds_jax_fleet_config(monkeypatch, tmp_path):
    """--fleet P --devices-per-proc N: the FleetConfig the JAX runner builds
    (processes, shards a process, the run directory's shards/ heartbeats,
    events and logs, the budget and backoff)."""
    port = _load_script(os.path.join(REPO, "scripts", "torch_resilient_run.py"), "t_runner2")
    jaxr = _load_script(os.path.join(REPO, "scripts", "resilient_run.py"), "j_runner2")
    cfgs = []
    for mod, owner, run in ((port, port, "port"), (jaxr, jsup, "jax")):
        # the JAX runner imports supervise_fleet from its supervisor in main()
        got = {}
        monkeypatch.setattr(owner, "supervise_fleet", lambda c, got=got: got.setdefault("c", c)
                            and 0)
        assert mod.main(["--fleet", "2", "--devices-per-proc", "2", "--run-dir",
                         str(tmp_path / run), "--max-restarts", "3", "--stall-timeout", "90",
                         "--", "echo", "hi"]) == 0
        cfgs.append(got["c"])
    cfg, jcfg = cfgs
    for f in ("num_processes", "devices_per_proc", "stall_timeout", "max_restarts",
              "backoff_base", "backoff_cap", "cmd", "reclaim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.heartbeat_dir == str(tmp_path / "port" / "shards")
    assert jcfg.heartbeat_dir == str(tmp_path / "jax" / "shards")


def test_product_script_runs_to_the_closed_form(tmp_path):
    """scripts/torch_run_product.py on the CPU: Kip320 TINY as one
    partition, 277 states, the record's match true (the preset's child at
    the smallest size)."""
    import subprocess

    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_run_product.py"),
                          "--base", "tiny", "--partitions", "1", "--cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, KSPEC_PROD_CKPT=str(tmp_path / "ck"),
                                  KSPEC_PROD_STATS=str(tmp_path / "stats.jsonl")))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["match"] and rec["distinct_states"] == rec["expected"] == 277
    assert os.path.exists(tmp_path / "ck" / "bfs_checkpoint.npz")
    assert len(open(tmp_path / "stats.jsonl").read().splitlines()) == rec["diameter"] + 1
