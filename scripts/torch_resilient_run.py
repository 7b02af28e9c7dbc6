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

Every flag is the JAX package's scripts/resilient_run.py's, but its fleet
and preset modes (--fleet, --devices-per-proc, --preset, --mem-budget,
--spill-dir), which come with the port's fleet.  This script imports only
the port's supervisor and obs/, neither of which imports torch: the
supervising process never holds a CUDA context.
"""

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from kafka_specification_tpu_torch.obs import RunContext  # noqa: E402 (no torch)
from kafka_specification_tpu_torch.resilience.supervisor import (  # noqa: E402
    SupervisorConfig,
    supervise,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="supervised auto-resume runner",
        usage="%(prog)s [options] -- CMD ...",
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
        "cmd",
        nargs=argparse.REMAINDER,
        metavar="-- CMD ...",
        help="child command (everything after --)",
    )
    args = ap.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use -- CMD ...)")
    # one run_id for the whole supervised run: the manifest records the
    # command and the restart lineage, the events, heartbeat and logs live
    # together, and `cli report <run-dir>` renders the result
    run_ctx = RunContext(args.run_dir)
    heartbeat = args.heartbeat or run_ctx.stats_path
    run_ctx.record_config(
        supervised=True,
        preset=None,
        cmd=cmd,
        heartbeat=heartbeat,
        fleet=None,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
    )
    print(f"[obs] run dir: {run_ctx.dir} (run {run_ctx.run_id})", file=sys.stderr)
    cfg = SupervisorConfig(
        cmd=cmd,
        heartbeat=heartbeat,
        events=args.events or run_ctx.events_path,
        log_dir=args.log_dir or run_ctx.log_dir,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
        backoff_base=args.backoff,
        backoff_cap=args.backoff_cap,
        env=dict(os.environ),
        run_id=run_ctx.run_id,
        reclaim=args.reclaim,
        reclaim_dirs=tuple(args.reclaim_dir),
    )
    return supervise(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
