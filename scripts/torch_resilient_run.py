"""Supervised auto-resume runner for the PyTorch port (the standalone form
of ``python -m kafka_specification_tpu_torch.cli check --resilient``).

Spawns a command as a child process in its own session, watches its
per-level JSONL heartbeat (the engine's --stats / stats_path stream),
kills the child's whole process group when the heartbeat stalls past
--stall-timeout (a run wedged on the card hangs without exiting), and
restarts it with a bounded restart budget and jittered exponential
backoff.  One heartbeat-enveloped JSONL event lands in --events per
transition (start / stall-kill / exit / restart / complete / give-up; on a
child's exit 75 resource-exhausted, then reclaim or resource-verdict).

The child owns its resume: the engine restarts from --checkpoint by
itself, so "restart" is exactly "run the same command again".

Usage:

    python scripts/torch_resilient_run.py --heartbeat RUN_stats.jsonl \\
        --events EVENTS.jsonl --stall-timeout 1800 --max-restarts 8 -- \\
        python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg \\
            --checkpoint .ckpt --stats RUN_stats.jsonl

    # the half-billion mixed464 product (scripts/torch_run_product.py
    # --base mixed464: one check() on the host backend, the disk tier with
    # --mem-budget), with the JAX package's preset's environment pins
    python scripts/torch_resilient_run.py --preset prod464 [--mem-budget 8G]

    # fleet mode: a whole P-process torch.distributed sharded run (one dead
    # or stalled process tears down and restarts the fleet from the newest
    # generation every shard agrees on)
    python scripts/torch_resilient_run.py --fleet 2 --devices-per-proc 2 -- \\
        python -m kafka_specification_tpu_torch.cli check \\
            configs/FiniteReplicatedLog.cfg --sharded --cpu --checkpoint .ckpt

Every flag is the JAX package's scripts/resilient_run.py's.  This script
imports only the port's supervisor and obs/, neither of which imports
torch: the supervising process never holds a CUDA context.
"""

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from kafka_specification_tpu_torch.obs import RunContext  # noqa: E402 (no torch)
from kafka_specification_tpu_torch.resilience.supervisor import (  # noqa: E402
    FleetConfig,
    SupervisorConfig,
    supervise,
    supervise_fleet,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="supervised auto-resume runner",
        usage="%(prog)s [options] [--preset prod464 | -- CMD ...]",
    )
    ap.add_argument(
        "--run-dir",
        help="obs run directory (default: runs/<run_id>/): the manifest, "
        "supervisor events, per-attempt logs, and (when the child doesn't "
        "say otherwise) the heartbeat all land here, correlated by one "
        "run_id; render it with `cli report`",
    )
    ap.add_argument(
        "--heartbeat",
        help="JSONL file the child appends progress to (growth = liveness; "
        "default: <run-dir>/stats.jsonl)",
    )
    ap.add_argument(
        "--events",
        help="supervisor JSONL event log (default: <run-dir>/events.jsonl)",
    )
    ap.add_argument(
        "--log-dir",
        help="directory for per-attempt child stdout/stderr logs "
        "(default: <run-dir>/logs/)",
    )
    ap.add_argument(
        "--stall-timeout",
        type=float,
        default=1800.0,
        help="kill the child after this many seconds without heartbeat "
        "growth (default 1800).  The heartbeat is one line per BFS level: "
        "set this ABOVE the longest level you expect, or a healthy "
        "mid-level run reads as a stall",
    )
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--backoff", type=float, default=5.0)
    ap.add_argument("--backoff-cap", type=float, default=300.0)
    ap.add_argument(
        "--reclaim",
        action="store_true",
        help="on a child RESOURCE_EXHAUSTED exit (code 75: full disk / "
        "breached budget, checkpointed clean), prune stale tmp files + "
        "rotated checkpoint generations under --reclaim-dir and retry "
        "EXACTLY once.  Default: halt with an actionable verdict; the "
        "supervisor never hot-loops restarts into an unreclaimed full disk",
    )
    ap.add_argument(
        "--reclaim-dir",
        action="append",
        default=[],
        metavar="DIR",
        help="directory the --reclaim sweep prunes (repeatable; typically "
        "the checkpoint and spill dirs)",
    )
    ap.add_argument(
        "--fleet",
        type=int,
        metavar="P",
        help="supervise a P-process torch.distributed fleet: the command "
        "after -- is launched P times (MASTER_ADDR / MASTER_PORT / "
        "WORLD_SIZE / RANK / LOCAL_RANK injected, a fresh port per "
        "attempt).  Per-process shard heartbeats land in <run-dir>/shards/ "
        "(KSPEC_SHARD_HEARTBEAT_DIR); a dead or stalled process tears the "
        "WHOLE fleet down and restarts it from the newest generation every "
        "shard agrees on",
    )
    ap.add_argument(
        "--devices-per-proc",
        type=int,
        help="[--fleet] shards per process of a CPU fleet's default mesh "
        "(KSPEC_CPU_SHARDS_PER_PROC; for rehearsal fleets without cards)",
    )
    ap.add_argument(
        "--preset",
        choices=["prod464"],
        help="prod464: the half-billion mixed464 exact product "
        "(torch_run_product.py --base mixed464, checkpoint in "
        "$KSPEC_PROD_CKPT)",
    )
    ap.add_argument(
        "--mem-budget",
        help="[--preset] host fingerprint-set byte budget (K/M/G "
        "suffixes): run the preset out-of-core through the disk tier "
        "(exported as KSPEC_PROD_MEMBUDGET to the child)",
    )
    ap.add_argument(
        "--spill-dir",
        help="[--preset] disk-tier directory for the preset child "
        "(exported as KSPEC_PROD_SPILL)",
    )
    ap.add_argument(
        "cmd",
        nargs=argparse.REMAINDER,
        metavar="-- CMD ...",
        help="child command (everything after --)",
    )
    args = ap.parse_args(argv)

    env = dict(os.environ)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    # one run_id for the whole supervised run: the manifest records the
    # command and the restart lineage, the events, heartbeat and logs live
    # together, and `cli report <run-dir>` renders the result
    run_ctx = RunContext(args.run_dir)
    heartbeat = args.heartbeat
    if args.preset == "prod464":
        if cmd:
            ap.error("--preset and an explicit command are mutually exclusive")
        # the JAX package's preset's environment pins
        env.setdefault("KSPEC_PROD_CKPT", os.path.join(_REPO, ".prod464_ckpt"))
        env.setdefault("KSPEC_ADAPTIVE_COMPACT", "0")
        # watch the path the child writes: a KSPEC_PROD_STATS already set
        # wins over both --heartbeat and the run directory's default
        heartbeat = env.get("KSPEC_PROD_STATS") or heartbeat or run_ctx.stats_path
        env["KSPEC_PROD_STATS"] = heartbeat
        if args.mem_budget:
            # out of core: the child's engine spills past the budget into
            # the disk tier (a restart resumes from the checkpointed run
            # manifests)
            env["KSPEC_PROD_MEMBUDGET"] = args.mem_budget
        if args.spill_dir:
            env["KSPEC_PROD_SPILL"] = args.spill_dir
        cmd = [sys.executable, os.path.join(_REPO, "scripts", "torch_run_product.py"),
               "--base", "mixed464"]
    if not cmd:
        ap.error("no command given (use -- CMD ... or --preset)")
    heartbeat = heartbeat or run_ctx.stats_path
    run_ctx.record_config(
        supervised=True,
        preset=args.preset,
        cmd=cmd,
        heartbeat=heartbeat,
        fleet=args.fleet,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
    )
    print(f"[obs] run dir: {run_ctx.dir} (run {run_ctx.run_id})", file=sys.stderr)
    if args.fleet:
        if args.preset:
            ap.error("--fleet and --preset are mutually exclusive")
        return supervise_fleet(FleetConfig(
            cmd=cmd,
            num_processes=args.fleet,
            events=args.events or run_ctx.events_path,
            heartbeat_dir=os.path.join(run_ctx.dir, "shards"),
            log_dir=args.log_dir or run_ctx.log_dir,
            stall_timeout=args.stall_timeout,
            max_restarts=args.max_restarts,
            backoff_base=args.backoff,
            backoff_cap=args.backoff_cap,
            env=env,
            run_id=run_ctx.run_id,
            devices_per_proc=args.devices_per_proc,
            reclaim=args.reclaim,
            reclaim_dirs=tuple(args.reclaim_dir),
        ))
    cfg = SupervisorConfig(
        cmd=cmd,
        heartbeat=heartbeat,
        events=args.events or run_ctx.events_path,
        log_dir=args.log_dir or run_ctx.log_dir,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
        backoff_base=args.backoff,
        backoff_cap=args.backoff_cap,
        env=env,
        run_id=run_ctx.run_id,
        reclaim=args.reclaim,
        reclaim_dirs=tuple(args.reclaim_dir),
    )
    return supervise(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
