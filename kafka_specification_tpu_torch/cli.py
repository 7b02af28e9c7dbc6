"""Command line of the PyTorch port: check or simulate a TLC .cfg, or
verify a checkpoint directory.

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

``check`` takes the options of the JAX package's ``cli check`` that the
ported engine serves, with the same names and defaults, and prints what it
prints: TLC's closing summary (distinct states, diameter, and on a
violation the invariant and a numbered counterexample trace, or the
violating state when no trace was kept), or with ``--json`` the
``kspec-verdict/1`` record (``verdict.py``).  The module defaults to the
.cfg file's stem; CHECK_DEADLOCK comes from the .cfg.  The check runs on
the card unless ``--cpu`` (or ``--device cpu``) is given.  ``--mem-budget``,
``--spill-dir`` and ``--store`` turn on the disk tier, ``--disk-budget``
arms the resource governor, and ``--fault`` sets ``$KSPEC_FAULT``.  Exit
codes: 0 no violation, 1 a violation, 2 an error, 75 a resource ran out
(RESOURCE_EXHAUSTED: a final checkpoint was saved, the same command resumes
once space is freed), 76 a failed integrity check (the level digest chain,
a spill file's checksum).

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
import sys
from pathlib import Path

from .engine.bfs import VISITED_BACKENDS
from .pipeline_registry import PIPELINES
from .resilience.checkpoints import CheckpointCorrupt
from .resilience.faults import FaultPlan, InjectedFault
from .resilience.integrity import EXIT_INTEGRITY, IntegrityError
from .resilience.resources import EXIT_RESOURCE_EXHAUSTED, ResourceExhausted
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


def _build(args):
    """(parsed .cfg, model), or None after printing why not."""
    try:
        tlc_cfg = parse_cfg(args.cfg)
    except (OSError, ValueError) as e:
        print(f"error: cannot parse {args.cfg}: {e}", file=sys.stderr)
        return None
    module = args.module or Path(args.cfg).stem
    try:
        return tlc_cfg, build_model(module, tlc_cfg)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
    return None


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
    if args.checkpoint_every < 1 or args.checkpoint_keep < 1:
        print("error: --checkpoint-every and --checkpoint-keep must be >= 1", file=sys.stderr)
        return EXIT_ERROR
    if args.fault:
        try:
            FaultPlan(args.fault)  # the grammar, before anything runs
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        os.environ["KSPEC_FAULT"] = args.fault
    built = _build(args)
    if built is None:
        return EXIT_ERROR
    tlc_cfg, model = built
    from .engine.bfs import check

    kw = {} if args.chunk_size is None else {"chunk_size": args.chunk_size}
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
            device="cpu" if args.cpu else args.device,
            **kw,
        )
    except IntegrityError as e:
        # the run's data failed a check: its own exit code, so a
        # supervisor resumes from the newest chain-verified generation
        print(f"INTEGRITY VIOLATION: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(error_verdict(f"INTEGRITY_VIOLATION[{e.site}]: {e.detail}",
                                           exit_code=EXIT_INTEGRITY)))
        return EXIT_INTEGRITY
    except ResourceExhausted as e:
        # a governed stop, not a crash: the engine saved what it could and
        # left every promoted generation verifiable
        print(f"RESOURCE EXHAUSTED: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(error_verdict(f"RESOURCE_EXHAUSTED[{e.reason}]: {e.detail}",
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
        rec = error_verdict(f"{type(e).__name__}: {e}")
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"error: {e}", file=sys.stderr)
        return verdict_exit_code(rec)
    rec = verdict_from_result(res)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kafka_specification_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="run the PyTorch engine on a TLC .cfg")
    pc.add_argument("cfg")
    pc.add_argument("--module", help="TLA+ module (default: cfg file stem)")
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
    return _simulate(args) if args.cmd == "simulate" else _check(args)


if __name__ == "__main__":
    sys.exit(main())
