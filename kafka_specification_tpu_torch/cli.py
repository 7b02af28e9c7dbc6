"""Command line of the PyTorch port: check or simulate a TLC .cfg, render
a run directory, list the fault grammar, or verify a checkpoint directory.

    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg
    python -m kafka_specification_tpu_torch.cli check configs/IdSequence.cfg --cpu --json
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg \
        --checkpoint ckpt/ --stats stats.jsonl --visited-backend host
    python -m kafka_specification_tpu_torch.cli check configs/AsyncIsr.cfg --cpu
    python -m kafka_specification_tpu_torch.cli simulate configs/Kip320Stretch.cfg \
        --module Kip320 --walks 10 --depth 50 --seed 0
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg \
        --mem-budget 16M --checkpoint ckpt/ --disk-budget 2G
    python -m kafka_specification_tpu_torch.cli verify-checkpoint ckpt/ --json
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg --run-dir runs/k320
    python -m kafka_specification_tpu_torch.cli report runs/k320
    python -m kafka_specification_tpu_torch.cli faults --list

``check`` takes the options of the JAX package's ``cli check`` that the
ported engine serves, with the same names and defaults, and prints what it
prints: TLC's closing summary (distinct states, diameter, and on a
violation the invariant and a numbered counterexample trace, or the
violating state when no trace was kept), or with ``--json`` the
``kspec-verdict/1`` record (``verdict.py``).  The module defaults to the
.cfg file's stem; CHECK_DEADLOCK comes from the .cfg.  The check runs on
the card unless ``--cpu`` (or ``--device cpu``) is given.  ``--mem-budget``,
``--spill-dir`` and ``--store`` turn on the disk tier, ``--disk-budget``
arms the resource governor, and ``--fault`` sets ``$KSPEC_FAULT`` (and
leaves it set, as the JAX package's CLI does).  Exit codes: 0 no
violation, 1 a violation, 2 an error, 75 a resource ran out
(RESOURCE_EXHAUSTED: a final checkpoint was saved, the same command resumes
once space is freed), 76 a failed integrity check (the level digest chain,
a spill file's checksum).

Every ``check`` opens a run directory (``obs/``; ``--run-dir``, default
``runs/<run_id>/`` under ``$KSPEC_RUNS_ROOT`` or the current directory;
an existing one is reopened under its run_id), says where on stderr, and
stamps the run_id into every record it writes: the verdict, the error
records and the stats lines.  A disk tier with neither ``--spill-dir``
nor ``--checkpoint`` spills under ``<run>/spill``, removed after a
completed run.  ``--profile DIR`` wraps the run in ``torch.profiler`` (CPU
activity, and CUDA activity on the card) and writes its Chrome trace to
``DIR/<run_id>.pt.trace.json``.  An error the port reports as an exit-2
record also finishes the manifest with status "error".

``report [RUN_DIR]`` renders a run directory (the JAX package's text, or
its record with ``--json``); with no directory it lists the runs under
``--root``, and ``--latest`` renders the newest.  ``faults --list`` prints
the fault grammar (``resilience/faults.py``).

``verify-checkpoint DIR`` checks a checkpoint directory offline (every
generation's checksums and digest chain, and the spill files its disk-tier
manifests reference): exit 0 iff every checkpoint chain has a resumable
generation, with the JAX package's report (``--json``) or its text.

``simulate`` is TLC's ``-simulate`` (``engine/simulate.py``): ``--walks``
random walks of at most ``--depth`` steps from ``--seed``, the same walks
as the JAX package's ``cli simulate``.  It prints what that prints: one
"Simulation: ..." line when no walk breaks an invariant (exit 0), else the
violation as ``check`` prints it, or its record with ``--json`` (exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

from .engine.bfs import VISITED_BACKENDS
from .obs import RunContext
from .obs.report import list_runs, render_report, render_run_index, report_data
from .obs.tracer import start_profiler, stop_profiler
from .pipeline_registry import PIPELINES
from .resilience.checkpoints import CheckpointCorrupt
from .resilience.faults import FaultPlan, InjectedFault, list_faults
from .resilience.integrity import EXIT_INTEGRITY, IntegrityError
from .resilience.resources import EXIT_RESOURCE_EXHAUSTED, ResourceExhausted, parse_bytes
from .storage import parse_mem_budget
from .utils.cfg import build_model, parse_cfg
from .verdict import EXIT_ERROR, error_verdict, verdict_exit_code, verdict_from_result


def _print_result(res, model_meta: dict) -> None:
    print(f"Model: {res.model}")
    print(
        f"{res.total} distinct states found, diameter {res.diameter}, "
        f"{res.seconds:.2f}s ({res.states_per_sec:,.0f} states/sec)"
    )
    if res.violation is None:
        print("No invariant violations. Exhaustive check complete.")
        return
    from .utils.pretty import render_state, render_trace

    v = res.violation
    print(f"Invariant {v.invariant} is VIOLATED at depth {v.depth}.")
    if v.trace:
        print("Counterexample trace:")
        print(render_trace(model_meta, v.trace))
    else:
        print("Violating state:")
        print(render_state(model_meta, v.state))


def _progress(depth, new_n, total):
    print(f"  level {depth}: {new_n} new, {total} total", file=sys.stderr)


def _parse(args):
    """The parsed .cfg, or None after printing why not."""
    try:
        return parse_cfg(args.cfg)
    except (OSError, ValueError) as e:
        print(f"error: cannot parse {args.cfg}: {e}", file=sys.stderr)
        return None


def _model(args, tlc_cfg):
    """The model of the .cfg's module, or None after printing why not."""
    try:
        return build_model(_module(args), tlc_cfg)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
    return None


def _module(args) -> str:
    return args.module or Path(args.cfg).stem


def _build(args):
    """(parsed .cfg, model), or None after printing why not."""
    tlc_cfg = _parse(args)
    model = None if tlc_cfg is None else _model(args, tlc_cfg)
    return None if model is None else (tlc_cfg, model)


def _simulate(args) -> int:
    built = _build(args)
    if built is None:
        return EXIT_ERROR
    _, model = built
    from .engine.simulate import simulate

    try:
        res = simulate(model, num_walks=args.walks, max_depth=args.depth, seed=args.seed,
                       device="cpu" if args.cpu else args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    if res.violation is None:
        print(
            f"Simulation: {args.walks} walks x depth {args.depth}, "
            f"{res.total} states visited, no violations "
            f"({res.states_per_sec:,.0f} states/sec)."
        )
        return 0
    if args.json:
        print(json.dumps(verdict_from_result(res)))
    else:
        _print_result(res, model.meta)
    return 1


def _check(args) -> int:
    tlc_cfg = _parse(args)
    if tlc_cfg is None:
        return EXIT_ERROR
    if args.checkpoint_every < 1 or args.checkpoint_keep < 1:
        print("error: --checkpoint-every and --checkpoint-keep must be >= 1", file=sys.stderr)
        return EXIT_ERROR
    # both byte budgets before the model is built, as the JAX package's CLI
    # does: a malformed one prints nothing on stdout, even under --json
    try:
        if args.mem_budget is not None:
            args.mem_budget = parse_mem_budget(args.mem_budget)
        if args.disk_budget is not None:
            args.disk_budget = parse_bytes(args.disk_budget)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    if args.fault:
        try:
            FaultPlan(args.fault)  # the grammar, before anything runs
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        os.environ["KSPEC_FAULT"] = args.fault
    model = _model(args, tlc_cfg)
    if model is None:
        return EXIT_ERROR
    from .engine.bfs import check

    # every check gets a run directory: manifest, stats, spans and metrics
    # under one run_id (`cli report` renders it, live or post-mortem)
    run_ctx = RunContext(args.run_dir)
    run_ctx.record_config(module=_module(args), cfg=args.cfg, sharded=False,
                          checkpoint=args.checkpoint, stats=args.stats)
    spill_defaulted = False
    if args.mem_budget is not None and args.spill_dir is None and args.checkpoint is None:
        # an un-homed disk tier spills under the run directory, so a
        # crashed run's spill sits next to its stats and spans; a
        # completed run removes it
        args.spill_dir = run_ctx.spill_dir
        spill_defaulted = True
    print(f"[obs] run dir: {run_ctx.dir} (run {run_ctx.run_id})", file=sys.stderr)
    kw = {} if args.chunk_size is None else {"chunk_size": args.chunk_size}
    prof = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof = start_profiler()
    try:
        res = check(
            model,
            max_depth=args.max_depth,
            max_states=args.max_states,
            store_trace=not args.no_trace,
            min_bucket=args.min_bucket,
            progress=_progress if args.progress else None,
            checkpoint_dir=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            check_deadlock=tlc_cfg.check_deadlock,
            stats_path=args.stats,
            visited_backend=args.visited_backend,
            pipeline=args.pipeline,
            mem_budget=args.mem_budget,
            spill_dir=args.spill_dir,
            store=args.store,
            disk_budget=args.disk_budget,
            run=run_ctx,
            device="cpu" if args.cpu else args.device,
            **kw,
        )
    except IntegrityError as e:
        # the run's data failed a check: its own exit code, so a
        # supervisor resumes from the newest chain-verified generation
        print(f"INTEGRITY VIOLATION: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(error_verdict(f"INTEGRITY_VIOLATION[{e.site}]: {e.detail}",
                                           run_id=run_ctx.run_id, exit_code=EXIT_INTEGRITY)))
        if args.checkpoint:
            print(f"  re-running resumes from the newest chain-verified generation in "
                  f"{args.checkpoint} (verify offline with `... verify-checkpoint "
                  f"{args.checkpoint}`).  Recurring violations on one host suggest failing "
                  f"hardware", file=sys.stderr)
        else:
            print("  no --checkpoint was configured: a re-run starts over (add --checkpoint "
                  "so integrity exits resume from the newest chain-verified generation)",
                  file=sys.stderr)
        return EXIT_INTEGRITY
    except ResourceExhausted as e:
        # a governed stop, not a crash: the engine saved what it could and
        # left every promoted generation verifiable
        print(f"RESOURCE EXHAUSTED: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(error_verdict(f"RESOURCE_EXHAUSTED[{e.reason}]: {e.detail}",
                                           run_id=run_ctx.run_id,
                                           exit_code=EXIT_RESOURCE_EXHAUSTED)))
        if args.checkpoint:
            print(f"  checkpoint intact at {args.checkpoint} — verify with `... "
                  f"verify-checkpoint {args.checkpoint}`, free space (or raise "
                  f"--disk-budget), then re-run the same command to resume", file=sys.stderr)
        else:
            print("  no --checkpoint was configured: a re-run starts over (add --checkpoint "
                  "to make resource exits resumable)", file=sys.stderr)
        return EXIT_RESOURCE_EXHAUSTED
    except InjectedFault:
        raise  # an injected crash is a crash, not an error record
    except (RuntimeError, ValueError, CheckpointCorrupt) as e:
        # no card, an unknown $KSPEC_PIPELINE, no g++ for the host set, a
        # checkpoint of another config or none that verifies: no result
        rec = error_verdict(f"{type(e).__name__}: {e}", run_id=run_ctx.run_id)
        run_ctx.finish("error", error=rec["error"])
        run_ctx.deactivate()
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"error: {e}", file=sys.stderr)
        return verdict_exit_code(rec)
    finally:
        if prof is not None:
            stop_profiler(prof, os.path.join(args.profile, f"{run_ctx.run_id}.pt.trace.json"))
    if spill_defaulted:
        # a completed run: the spilled fingerprints are dead weight (the
        # spill accounting lives on in the metrics and spans)
        shutil.rmtree(run_ctx.spill_dir, ignore_errors=True)
    rec = verdict_from_result(res, run_id=run_ctx.run_id)
    if args.json:
        print(json.dumps(rec))
    else:
        _print_result(res, model.meta)
    return verdict_exit_code(rec)


def _print_verify_checkpoint(rep: dict) -> None:
    print(f"Checkpoint directory: {rep['dir']}")
    if rep.get("error"):
        print(f"  ERROR: {rep['error']}")
    if not rep["stores"]:
        print("  no checkpoint files found")
    for store in rep["stores"]:
        print(f"  {store['basename']}: {'OK' if store['ok'] else 'NOT RESUMABLE'}")
        for g in store["generations"]:
            bits = [f"gen {g['gen']}", f"depth {g.get('depth')}"]
            if g.get("digest_chain") and g["digest_chain"] != "absent":
                bits.append(f"chain {g['digest_chain']}")
            if "spill" in g:
                bits.append(f"spill {g['spill']['files_checked']} files "
                            + ("resolved" if g["spill"]["ok"] else "BROKEN"))
            status = "ok" if g["ok"] else "FAILED"
            print(f"    {status:>6}  " + "  ".join(bits))
            for e in g["errors"]:
                print(f"            - {e}")
    print(f"Verdict: {'resumable' if rep['ok'] else 'NOT resumable'}")


def _verify_checkpoint(args) -> int:
    from .resilience.checkpoints import verify_checkpoint_dir

    rep = verify_checkpoint_dir(args.ckpt_dir, spill_dir=args.spill_dir)
    if args.json:
        print(json.dumps(rep, default=str))
    else:
        _print_verify_checkpoint(rep)
    return 0 if rep["ok"] else 1


def _report(args) -> int:
    """`cli report`: one run directory, or the index of a runs root."""
    run_dir = args.run_dir
    if run_dir is None:
        root = args.root or os.environ.get("KSPEC_RUNS_ROOT", "runs")
        if args.latest:
            runs = list_runs(root, limit=1)
            if not runs:
                print(f"no runs under {root}", file=sys.stderr)
                return 1
            run_dir = runs[0]["dir"]
        else:
            runs = list_runs(root)
            if args.json:
                print(json.dumps(runs, default=str))
            else:
                print(render_run_index(root, runs))
            return 0
    if args.json:
        print(json.dumps(report_data(run_dir), default=str))
    else:
        print(render_report(run_dir))
    return 0


def _faults(args) -> int:
    """`cli faults --list`: the fault grammar, from the registry the
    parser validates against."""
    entries = list_faults()
    if args.json:
        print(json.dumps(entries))
        return 0
    print("Injectable faults (KSPEC_FAULT / --fault; comma-separate "
          "to compose; every fault takes a `shard<d>:` scope after "
          "the '@'):")
    for e in entries:
        print(f"  {e['grammar']}")
        print(f"      {e['description']}")
    print("Examples: crash@level:7   enospc@spill:2   "
          "flip@shard1:exchange:3   corrupt_ckpt@ckpt:4")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kafka_specification_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="run the PyTorch engine on a TLC .cfg")
    pc.add_argument("cfg")
    pc.add_argument("--module", help="TLA+ module (default: cfg file stem)")
    pc.add_argument(
        "--run-dir",
        help="run directory for this invocation's manifest + stats + spans "
        "+ metrics (default: runs/<run_id>/ under $KSPEC_RUNS_ROOT or the "
        "cwd; reopening an existing run dir resumes its run_id).  Render it "
        "later with `cli report`",
    )
    pc.add_argument("--max-depth", type=int)
    pc.add_argument("--max-states", type=int)
    pc.add_argument("--no-trace", action="store_true", help="skip trace storage")
    pc.add_argument("--min-bucket", type=int, default=256)
    pc.add_argument(
        "--chunk-size",
        type=int,
        default=None,
        help="max frontier rows per chunk (default: the engine's, 32768)",
    )
    pc.add_argument("--progress", action="store_true")
    pc.add_argument("--json", action="store_true", help="print the kspec-verdict/1 record")
    pc.add_argument(
        "--checkpoint", help="directory for level-synchronous checkpoint/resume"
    )
    pc.add_argument(
        "--checkpoint-every",
        type=int,
        default=1,
        help="persist a checkpoint every N BFS levels (default 1)",
    )
    pc.add_argument(
        "--checkpoint-keep",
        type=int,
        default=3,
        help="rotated checkpoint generations to keep (default 3; corrupt "
        "newest falls back to the next verifying one)",
    )
    pc.add_argument(
        "--stats", help="append per-level JSONL stats (e.g. PROGRESS.jsonl)"
    )
    pc.add_argument(
        "--visited-backend",
        choices=list(VISITED_BACKENDS),
        default="device",
        help="fingerprint set: 'device' = sorted pair set in device memory, "
        "'device-hash' = open-addressing hash table in device memory, "
        "'host' = the native C++ FpSet in host memory (past host memory: "
        "--mem-budget, the disk tier)",
    )
    pc.add_argument(
        "--mem-budget",
        metavar="BYTES",
        help="host fingerprint-set byte budget before spilling to the "
        "disk tier (suffixes K/M/G, e.g. 4G).  Setting this activates "
        "--store=auto's disk tier: sorted bloom-gated runs + spilled "
        "frontier + on-disk parent log under --spill-dir",
    )
    pc.add_argument(
        "--spill-dir",
        metavar="DIR",
        help="directory for the disk tier's runs/frontier/parent log "
        "(default: <--checkpoint>/spill, else a temp dir)",
    )
    pc.add_argument(
        "--store",
        choices=["auto", "ram", "disk"],
        default="auto",
        help="state-storage tier: 'ram' = in-memory only, 'disk' = tiered "
        "out-of-core store (implies the host fingerprint backend), 'auto' "
        "= disk exactly when --mem-budget is set (default)",
    )
    pc.add_argument(
        "--disk-budget",
        metavar="BYTES",
        help="byte budget for the spill + checkpoint directories "
        "(suffixes K/M/G).  Crossing the soft fraction triggers "
        "reclamation (eager merges, generation pruning); a hard breach "
        "checkpoints and exits with the typed RESOURCE_EXHAUSTED status "
        f"(exit code {EXIT_RESOURCE_EXHAUSTED}), resumable after space "
        "is freed.  KSPEC_DISK_BUDGET is the env twin; KSPEC_RSS_BUDGET / "
        "KSPEC_LEVEL_DEADLINE arm the RSS and per-level-deadline watchdogs",
    )
    pc.add_argument(
        "--fault",
        metavar="PLAN",
        help="deterministic fault injection plan (sets KSPEC_FAULT; e.g. "
        "'crash@level:7', 'corrupt_ckpt', 'flip@frontier:3', 'enospc@spill:2'; "
        "the grammar is in resilience/faults.py, and a site this engine does "
        "not wire is refused)",
    )
    pc.add_argument(
        "--profile",
        metavar="DIR",
        help="wrap the run in a torch.profiler trace (CPU, and CUDA on the "
        "card), written to DIR/<run_id>.pt.trace.json (Chrome trace format)",
    )
    pc.add_argument(
        "--pipeline",
        choices=list(PIPELINES),
        default=None,
        help="level pipeline: 'fused' (default; $KSPEC_PIPELINE overrides), "
        "'legacy', or 'device' (every gated chunk of a level queued on the card, "
        "one host read a level); all give the same result",
    )
    pc.add_argument(
        "--device",
        default=None,
        help="torch device to check on (default: the card, 'cuda'; 'cpu' runs "
        "the plain versions of the kernels)",
    )
    pc.add_argument("--cpu", action="store_true", help="force the CPU platform (--device cpu)")
    pvc = sub.add_parser(
        "verify-checkpoint",
        help="offline integrity check of a checkpoint directory: per-array "
        "CRC manifests of every generation, the digest chain, and "
        "storage-manifest resolvability (disk-tier run files).  Touches no "
        "card.  Exit 0 iff every checkpoint chain has a resumable generation",
    )
    pvc.add_argument("ckpt_dir")
    pvc.add_argument(
        "--spill-dir",
        help="disk-tier directory the storage manifests resolve against "
        "(default: <ckpt_dir>/spill, the engine's default placement)",
    )
    pvc.add_argument("--json", action="store_true", help="machine-readable report")
    pr = sub.add_parser(
        "report",
        help="render a run directory (manifest + stats + spans + metrics) "
        "into a human summary: per-level throughput, action enablement, "
        "spill accounting, event timeline, ETA, stall verdict.  Works on "
        "live and crashed-mid-run directories; touches no card.  With no "
        "run dir: index the recent runs under --root",
    )
    pr.add_argument("run_dir", nargs="?",
                    help="run directory to render (omit to list recent runs)")
    pr.add_argument("--latest", action="store_true",
                    help="render the newest run under --root instead of listing")
    pr.add_argument("--root", help="runs root for the no-argument index / --latest "
                    "(default: $KSPEC_RUNS_ROOT or ./runs)")
    pr.add_argument("--json", action="store_true", help="machine-readable report")
    pf = sub.add_parser(
        "faults",
        help="enumerate every injectable fault site (the KSPEC_FAULT / --fault "
        "grammar) from the registry the parser validates against",
    )
    pf.add_argument("--list", action="store_true", dest="list_faults",
                    help="list the fault registry (the default action)")
    pf.add_argument("--json", action="store_true")
    ps = sub.add_parser("simulate", help="random-walk checking (TLC -simulate equivalent)")
    ps.add_argument("cfg")
    ps.add_argument("--module", help="TLA+ module (default: cfg file stem)")
    ps.add_argument("--walks", type=int, default=100)
    ps.add_argument("--depth", type=int, default=100)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--json", action="store_true",
                    help="print a violation as its kspec-verdict/1 record")
    ps.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' runs the plain kernels)")
    ps.add_argument("--cpu", action="store_true", help="force the CPU platform (--device cpu)")
    args = p.parse_args(argv)
    if args.cmd == "verify-checkpoint":
        return _verify_checkpoint(args)
    if args.cmd == "report":
        return _report(args)
    if args.cmd == "faults":
        return _faults(args)
    return _simulate(args) if args.cmd == "simulate" else _check(args)


if __name__ == "__main__":
    sys.exit(main())
