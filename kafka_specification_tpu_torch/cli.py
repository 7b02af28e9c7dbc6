"""Command line of the PyTorch port: check or simulate a TLC .cfg, run the
reference interpreter on it, analyze the specs and the engine sources, list
the level pipelines or the fault grammar, render a run directory, or verify
a checkpoint directory.

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
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg --resilient \
        --checkpoint ckpt/ --run-dir runs/k320r
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg --integrity-shadow 0.1
    python -m kafka_specification_tpu_torch.cli check configs/Kip320.cfg --sharded
    torchrun --nproc-per-node 2 -m kafka_specification_tpu_torch.cli check \
        configs/FiniteReplicatedLog.cfg --sharded --cpu --visited-backend host
    python -m kafka_specification_tpu_torch.cli faults --list
    python -m kafka_specification_tpu_torch.cli crashcheck --json
    python -m kafka_specification_tpu_torch.cli simfleet run --seeds 50
    python -m kafka_specification_tpu_torch.cli oracle configs/Kip320.cfg
    python -m kafka_specification_tpu_torch.cli pipelines --json
    python -m kafka_specification_tpu_torch.cli analyze --json

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
the fault grammar (``resilience/faults.py``) and the crashcheck scenarios.

``crashcheck`` runs the crash-consistency harness
(``resilience/crashcheck/``): each durable protocol's recorded op-trace,
every legal crash state of it, and the protocol's recovery on each (exit
1 on a non-convergent state; ``--json`` the ``kspec-crashcheck/1``
record).  ``simfleet run|replay`` is the deterministic fleet simulation
(``resilience/simfleet/``): seeded schedules over the real control plane
under a virtual clock, violations shrunk to ``kspec-simfleet/1`` repros.
Both, and ``faults``, import no torch.

``check --resilient`` runs the same check as a child process under the
auto-resume supervisor (``resilience/supervisor.py``): the child's
``--stats`` stream is its heartbeat (default: the run directory's
``stats.jsonl``), a child whose heartbeat stalls past ``--stall-timeout``
is killed with its whole process group, a crashed child is restarted
(resuming from ``--checkpoint``) with backoff up to ``--max-restarts``
times, exit 75 halts with a verdict (``--reclaim``: prune stale tmp files
and rotated generations, retry once), and every transition is an event in
``--events`` (default: the run directory's ``events.jsonl``), with each
attempt's output under its ``logs/``.  The supervising process resolves no
device and touches no card.  ``--integrity-shadow RATE`` samples chunks for
the host fingerprint oracle (``check(integrity_shadow=)``; a mismatch is
exit 76).

``check --sharded`` runs the sharded engine (``parallel/sharded.py``): one
shard per device the runtime exposes, the shards of the process group when
there is one.  The process joins the group before anything touches a
device when torchrun's variables (``MASTER_ADDR``, ``WORLD_SIZE``,
``RANK``, ...) or ``KSPEC_MULTIHOST=1`` are set: NCCL on the card, gloo
with ``--cpu``.  ``--integrity-shadow`` is refused under ``--sharded``
(exit 2), as in the JAX package.

``verify-checkpoint DIR`` checks a checkpoint directory offline (every
generation's checksums and digest chain, the per-host part files a sharded
generation needs, and the spill files its disk-tier manifests reference):
exit 0 iff every checkpoint chain has a resumable generation, with the JAX
package's report (``--json``) or its text.

``simulate`` is TLC's ``-simulate`` (``engine/simulate.py``): ``--walks``
random walks of at most ``--depth`` steps from ``--seed``, the same walks
as the JAX package's ``cli simulate``.  It prints what that prints: one
"Simulation: ..." line when no walk breaks an invariant (exit 0), else the
violation as ``check`` prints it, or its record with ``--json`` (exit 1).

``oracle`` runs the reference interpreter (``oracle/``, the model's
set-semantics twin) on the host, as the JAX package's ``cli oracle``:
"Oracle: N distinct states, diameter D, ...", then no violation (exit 0)
or the violated invariant, its depth and the rendered trace (exit 1).

``pipelines`` prints the level-pipeline registry (``pipeline_registry.py``)
with each entry's support matrix, or with ``--json`` the list itself.

``analyze`` is the static analysis (``analysis/``): the encoding and
action passes over the models of the given .cfg files (default: every
``configs/*.cfg``), then the ownership and purity passes over the port's
engine sources, the trace vocabulary, and the durable-io and raw-clock
lints.  It prints the findings (``--json``: the
``kspec-analysis/1`` record) and exits 0 with no HIGH finding, 1 with
one, and 2 when a target cannot be analyzed or ``--module`` is given with
other than one .cfg.  ``oracle``, ``pipelines`` and ``analyze`` touch no
card.

``serve [SERVICE_DIR]`` runs the serving daemon (``service/``): one warm
process that drains the durable job queue on the card, with the JAX
package's flags (``--cpu`` runs it on the CPU, ``--device`` names a card;
without either, on a machine without CUDA it exits 2 before it claims a
job).  ``--supervised`` runs it under the auto-restart supervisor, watching
its heartbeat.  ``submit CFG`` queues a check (``--wait`` blocks for the
verdict and exits with its code), ``status [JOB_ID]`` says where a job is
(exit 1 for an unknown job), and ``result JOB_ID`` prints its
``kspec-verdict/1`` record and exits with its code (2 when there is none).
The service directory defaults to ``$KSPEC_SERVICE_DIR``, else
``./service``.  The three client verbs import no torch, and with
``--router DIR`` they go through a routed fleet.

``serve-fleet [SERVICE_DIR]`` runs N ``serve`` children over one service
directory under the fleet supervisor (``service/fleet.py``; the device
flags pass through, the parent imports no torch).  ``route ROUTER_DIR
--hosts DIR...`` fronts several hosts' service directories
(``service/router.py``).  ``trace JOB_ID``, ``top`` and ``fleet-report``
render the fleet traces (``obs/fleettrace.py``), and ``report`` of a
router or sweep directory renders its rollup.  ``sweep
plan|run|report|bisect`` drives a config lattice through the service
(``sweep/``).  All of these are the JAX package's verbs, with its records,
text and exit codes.

    python -m kafka_specification_tpu_torch.cli serve svc --max-jobs 1 &
    python -m kafka_specification_tpu_torch.cli submit configs/Kip320.cfg \
        --service-dir svc --wait --json
    python -m kafka_specification_tpu_torch.cli serve-fleet svc --daemons 2 &
    python -m kafka_specification_tpu_torch.cli route rt --hosts h0 h1 &
    python -m kafka_specification_tpu_torch.cli submit configs/Kip320.cfg --router rt
    python -m kafka_specification_tpu_torch.cli trace JOB_ID --router rt
    python -m kafka_specification_tpu_torch.cli sweep run lattice.json --sweep-dir sw \
        --service-dir svc
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

from .obs import RunContext
from .obs.report import list_runs, render_report, render_run_index, report_data
from .obs.tracer import start_profiler, stop_profiler
from .pipeline_registry import BACKENDS as VISITED_BACKENDS
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


def _model(args, tlc_cfg, oracle: bool = False):
    """The model of the .cfg's module (its oracle twin with `oracle`), or
    None after printing why not."""
    try:
        return build_model(_module(args), tlc_cfg, oracle=oracle)
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


def _check(args, argv) -> int:
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
    if args.sharded and args.integrity_shadow:
        # shadow re-execution is a single-device oracle; dropping the flag
        # on a sharded run would report a clean pass
        print(
            "error: --integrity-shadow is single-device only (the shadow "
            "oracles are the legacy pipeline + host fingerprint oracle); "
            "re-run without --sharded to localize corruption",
            file=sys.stderr,
        )
        return EXIT_ERROR
    if args.fault:
        try:
            FaultPlan(args.fault)  # the grammar, before anything runs
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        os.environ["KSPEC_FAULT"] = args.fault
    if args.resilient:
        # before the model is built or a device resolved: the supervisor
        # only re-runs this command as its child
        return _run_resilient(args, argv)
    device = "cpu" if args.cpu else args.device
    if os.environ.get("MASTER_ADDR") or os.environ.get("KSPEC_MULTIHOST") == "1":
        # a process of a torchrun (or KSPEC_MULTIHOST=1) job joins its group
        # before anything touches a device
        from .parallel.multihost import init_distributed

        info = init_distributed(device)
        if info["process_count"] > 1:
            print(f"[fleet] process {info['process_id']}/{info['process_count']} "
                  f"({info['local_devices']} local / {info['global_devices']} global devices)",
                  file=sys.stderr)
    model = _model(args, tlc_cfg)
    if model is None:
        return EXIT_ERROR
    from .engine.bfs import check
    from .parallel.multihost import is_coordinator
    from .resilience.integrity import shadow_rate

    # every check gets a run directory: manifest, stats, spans and metrics
    # under one run_id (`cli report` renders it, live or post-mortem)
    run_ctx = RunContext(args.run_dir) if is_coordinator() else None
    if run_ctx is not None:
        run_ctx.record_config(module=_module(args), cfg=args.cfg, sharded=args.sharded,
                              checkpoint=args.checkpoint, stats=args.stats)
    spill_defaulted = False
    if (args.mem_budget is not None and args.spill_dir is None and args.checkpoint is None
            and run_ctx is not None):
        # an un-homed disk tier spills under the run directory, so a
        # crashed run's spill sits next to its stats and spans; a
        # completed run removes it
        args.spill_dir = run_ctx.spill_dir
        spill_defaulted = True
    # one run directory a job: in a multi-process run only process 0 opens it
    run_id = run_ctx.run_id if run_ctx is not None else None
    if run_ctx is not None:
        print(f"[obs] run dir: {run_ctx.dir} (run {run_ctx.run_id})", file=sys.stderr)
    kw = {} if args.chunk_size is None else {"chunk_size": args.chunk_size}
    try:
        shadow_rate(args.integrity_shadow)
    except ValueError as e:
        # the JAX package's CLI lets this escape check() as a crash: its
        # exit code (1) and its last line
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    prof = None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof = start_profiler()
    try:
        common = dict(
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
            overlap=args.overlap,
            device=device,
            **kw,
        )
        if args.sharded:
            from .parallel.sharded import check_sharded

            res = check_sharded(model, **common)
        else:
            res = check(model, integrity_shadow=args.integrity_shadow, **common)
    except IntegrityError as e:
        # the run's data failed a check: its own exit code, so a
        # supervisor resumes from the newest chain-verified generation
        print(f"INTEGRITY VIOLATION: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(error_verdict(f"INTEGRITY_VIOLATION[{e.site}]: {e.detail}",
                                           run_id=run_id, exit_code=EXIT_INTEGRITY)))
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
                                           run_id=run_id,
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
        rec = error_verdict(f"{type(e).__name__}: {e}", run_id=run_id)
        if run_ctx is not None:
            run_ctx.finish("error", error=rec["error"])
            run_ctx.deactivate()
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"error: {e}", file=sys.stderr)
        return verdict_exit_code(rec)
    finally:
        if prof is not None:
            stop_profiler(prof, os.path.join(args.profile, f"{run_id}.pt.trace.json"))
    if spill_defaulted:
        # a completed run: the spilled fingerprints are dead weight (the
        # spill accounting lives on in the metrics and spans)
        shutil.rmtree(run_ctx.spill_dir, ignore_errors=True)
    rec = verdict_from_result(res, run_id=run_id)
    if args.json:
        print(json.dumps(rec))
    else:
        _print_result(res, model.meta)
    return verdict_exit_code(rec)


def _run_resilient(args, argv) -> int:
    """`check --resilient`: re-run this command under the supervisor.

    The child is this same CLI minus --resilient; the engine resumes from
    --checkpoint by itself, so a restart is just a re-run.  This process
    opens the run directory and hands it to every child attempt: one
    run_id correlates the supervisor's events with each attempt's stats
    and spans (a restart reopens the run, appending to its lineage)."""
    from .resilience.supervisor import SupervisorConfig, supervise

    # strip the flag AND its argparse prefix abbreviations ("--resil" also
    # sets args.resilient; letting it through would make every child spawn
    # its own supervisor)
    child_argv = [a for a in argv if not (a.startswith("--re") and "--resilient".startswith(a))]
    run_ctx = RunContext(args.run_dir)
    if args.run_dir is None:
        child_argv += ["--run-dir", run_ctx.dir]
    if not args.stats:
        # the heartbeat lives in the run directory by default: the stall
        # detector always has a stream to watch
        args.stats = run_ctx.stats_path
        child_argv += ["--stats", args.stats]
    if not args.checkpoint:
        print("warning: --resilient without --checkpoint — a restarted run starts over from "
              "the initial states", file=sys.stderr)
    events = args.events or run_ctx.events_path
    run_ctx.record_config(module=_module(args), cfg=args.cfg, supervised=True,
                          stall_timeout=args.stall_timeout, max_restarts=args.max_restarts)
    if args.checkpoint:
        os.makedirs(args.checkpoint, exist_ok=True)
    print(f"[obs] run dir: {run_ctx.dir} (run {run_ctx.run_id})", file=sys.stderr)
    cfg = SupervisorConfig(
        cmd=[sys.executable, "-m", "kafka_specification_tpu_torch.cli"] + child_argv,
        heartbeat=args.stats,
        events=events,
        log_dir=run_ctx.log_dir,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
        env=dict(os.environ),
        run_id=run_ctx.run_id,
        # resource-exit policy: halt with a verdict, or prune and retry
        # once under --reclaim (never restart into a full disk)
        reclaim=bool(args.reclaim),
        reclaim_dirs=tuple(d for d in (args.checkpoint, args.spill_dir) if d),
    )
    return supervise(cfg)


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
            if "mesh_D" in g:
                bits.append(f"shards {g['mesh_D']} x procs {g.get('mesh_P')}")
            if g.get("digest_chain") and g["digest_chain"] != "absent":
                bits.append(f"chain {g['digest_chain']}")
            if g.get("parts"):
                bits.append("parts " + ",".join(
                    f"{p}@{gen}" if gen is not None else f"{p}@MISSING"
                    for p, gen in sorted(g["parts"].items())))
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
    """`cli report`: one run directory, a router or sweep directory (their
    rollups), or the index of a runs root."""
    run_dir = args.run_dir
    if run_dir is not None and os.path.isfile(os.path.join(run_dir, "router.json")):
        from .obs.report import render_router_report, router_report_data

        data = router_report_data(run_dir)
        print(json.dumps(data) if args.json else render_router_report(data))
        return 0
    if run_dir is not None and os.path.isfile(os.path.join(run_dir, "sweep.json")):
        from .obs.report import render_sweep_report, sweep_report_data

        data = sweep_report_data(run_dir)
        print(json.dumps(data) if args.json else render_sweep_report(data))
        return 0
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
    parser validates against, then the crashcheck scenarios."""
    from .resilience.crashcheck import list_scenarios

    entries = list_faults()
    scenarios = list_scenarios()
    if args.json:
        # the scenario rows ride along as extra entries of the same flat
        # list, tagged by kind
        print(json.dumps(entries + [
            {"kind": "crashcheck-scenario",
             "grammar": f"crashcheck --protocol {s['protocol']}",
             "sites": [s["name"]],
             "description": s["description"],
             "scopeable": False}
            for s in scenarios
        ]))
        return 0
    print("Injectable faults (KSPEC_FAULT / --fault; comma-separate "
          "to compose; every fault takes a `shard<d>:` scope after "
          "the '@'):")
    for e in entries:
        print(f"  {e['grammar']}")
        print(f"      {e['description']}")
    print("Examples: crash@level:7   enospc@spill:2   "
          "flip@shard1:exchange:3   corrupt_ckpt@ckpt:4")
    print()
    print("Crashcheck scenarios (`cli crashcheck --protocol P`; "
          "enumerated crash states, not injected faults):")
    for s in scenarios:
        print(f"  {s['protocol']}: {s['name']}")
        print(f"      {s['description']}")
    return 0


def _crashcheck(args) -> int:
    """`cli crashcheck`: every legal crash state of each durable protocol,
    each run through the protocol's own recovery.  Exit 0 when all
    converge, 1 on a non-convergent state, 2 for an unknown protocol."""
    from .resilience.crashcheck import run_crashcheck

    try:
        rec = run_crashcheck(protocols=args.protocols)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    if args.json:
        print(json.dumps(rec))
    else:
        print(f"kspec crashcheck: {rec['states']} crash states / "
              f"{len(rec['protocols'])} protocol(s) in "
              f"{rec['seconds']}s — "
              f"{rec['non_convergent']} non-convergent")
        for s in rec["scenarios"]:
            print(f"  {s['protocol']:<8} {s['name']:<18} "
                  f"{s['states']:>4} states  "
                  f"{s['non_convergent']} non-convergent")
        for f in rec["findings"]:
            print(f"  FINDING {f['scenario']} prefix={f['prefix']} "
                  f"degraded={f['degraded']} "
                  f"state={f['state_digest']}")
            for v in f["violations"]:
                print(f"    {v}")
    return 0 if rec["ok"] else 1


def _run_simfleet(args) -> int:
    """`cli simfleet run|replay`: the deterministic fleet simulator.

    Exit codes — run: 0 = every seed clean, 1 = violations (repros
    banked under --out), 2 = bad arguments.  replay: 0 = the repro
    still reproduces its recorded violation, 2 = stale."""
    from .resilience import simfleet as sf

    if args.sf_cmd == "run":
        cfg = sf.SimConfig(hosts=args.hosts, jobs=args.jobs,
                           steps=args.steps)
        if args.seeds < 1 or args.hosts < 1 or args.jobs < 0:
            print("error: --seeds/--hosts must be >= 1", file=sys.stderr)
            return EXIT_ERROR
        seeds = range(args.start_seed, args.start_seed + args.seeds)
        summary = sf.sweep_seeds(
            seeds, config=cfg, coverage=args.coverage,
            max_extra=max(2, args.seeds // 5) if args.coverage else 0,
        )
        banked = []
        for hit in summary["violating"]:
            seed, record = hit["seed"], hit["record"]
            v = record["violations"][0]
            try:
                small, srec = sf.shrink(record["schedule"], cfg, seed,
                                        v["oracle"])
            except ValueError:
                # a drain-phase-only violation on an empty-ish schedule:
                # the full schedule is the minimal repro
                small, srec = record["schedule"], record
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(
                args.out, f"repro-seed{seed}-{v['oracle']}.json")
            # bank the violation as the SHRUNK run reports it: job ids
            # shift when submit events drop out of the schedule, and a
            # repro must name a job that exists in its own replay
            sv = next((w for w in srec["violations"]
                       if w["oracle"] == v["oracle"]), v)
            sf.save_repro(path, seed, cfg, sv, small, srec,
                          shrunk_from=len(record["schedule"]))
            banked.append({"seed": seed, "oracle": v["oracle"],
                           "events": len(small), "path": path})
        rec = {
            "schema": "kspec-simfleet-sweep/1",
            "config": summary["config"],
            "runs": summary["runs"],
            "clean": summary["clean"],
            "pair_coverage": summary["pair_coverage"],
            "violations": banked,
            "ok": not banked,
        }
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"kspec simfleet: {rec['runs']} seed(s) — "
                  f"{rec['clean']} clean, {len(banked)} violating "
                  f"({rec['pair_coverage']} event-pair(s) covered)")
            for b in banked:
                print(f"  VIOLATION seed {b['seed']}: {b['oracle']} — "
                      f"shrunk to {b['events']} event(s), repro at "
                      f"{b['path']}")
        return 0 if rec["ok"] else 1

    # replay
    try:
        repro = sf.load_repro(args.repro)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    out = sf.replay_repro(repro, keep_root=args.trace)
    record = out["record"]
    rec = {
        "schema": "kspec-simfleet-replay/1",
        "repro": {k: repro[k] for k in
                  ("seed", "violation", "events_digest", "shrunk_from")},
        "reproduced": out["reproduced"],
        "digest_match": out["digest_match"],
        "violations": record["violations"],
    }
    try:
        if args.json:
            print(json.dumps(rec))
        else:
            v = repro["violation"]
            state = ("REPRODUCED" if out["reproduced"] else
                     "STALE (violation no longer fires)")
            print(f"kspec simfleet replay: {state} — {v['oracle']} "
                  f"on {v['job']} over {len(repro['schedule'])} "
                  f"event(s); digest "
                  f"{'match' if out['digest_match'] else 'DRIFT'}")
            for got in record["violations"]:
                print(f"  {got['oracle']} @step {got['step']} "
                      f"job={got['job']}: {got['detail']}")
            if args.trace and out["kernel"] is not None:
                from .obs import fleettrace as ft

                job = (next((g["job"] for g in record["violations"]
                             if g.get("job")), None)
                       or v.get("job")
                       or next(iter(record["verdicts"]), None))
                if job:
                    recs = ft.load_trace(out["kernel"].trace_roots(), job)
                    if recs:
                        print()
                        print(ft.render_trace(ft.assemble(recs, job)))
                    else:
                        print(f"  (no trace records for {job})")
    finally:
        if out["kernel"] is not None:
            out["kernel"].cleanup()
    return 0 if out["reproduced"] else 2


def _oracle(args) -> int:
    """`cli oracle`: the reference interpreter on the .cfg's model, on the
    host (the JAX package's handler and lines)."""
    import time

    from .oracle.interp import oracle_bfs

    tlc_cfg = _parse(args)
    om = None if tlc_cfg is None else _model(args, tlc_cfg, oracle=True)
    if om is None:
        return EXIT_ERROR
    t0 = time.perf_counter()
    r = oracle_bfs(
        om,
        max_depth=args.max_depth,
        max_states=args.max_states,
        keep_level_sets=False,
        check_deadlock=tlc_cfg.check_deadlock,
    )
    dt = time.perf_counter() - t0
    print(
        f"Oracle: {r.total} distinct states, diameter {r.diameter}, "
        f"{dt:.2f}s ({r.total / max(dt, 1e-9):,.0f} states/sec)"
    )
    if r.violation:
        name, depth, _ = r.violation
        print(f"Invariant {name} is VIOLATED at depth {depth}.")
        from .utils.pretty import render_trace

        print("Counterexample trace:")
        print(render_trace(om.meta, r.trace))
    else:
        print("No invariant violations. Exhaustive check complete.")
    return 0 if r.violation is None else 1


def _pipelines(args) -> int:
    """`cli pipelines`: the registry the --pipeline parser and the engine's
    resolve_pipeline validate against, with every support cell."""
    from .pipeline_registry import list_pipelines

    entries = list_pipelines()
    if args.json:
        print(json.dumps(entries))
        return 0
    print("Registered level pipelines (--pipeline / $KSPEC_PIPELINE; "
          "engine/pipeline.py):")
    for e in entries:
        tag = " (default)" if e["default"] else ""
        fb = (f" -> degrades to '{e['fallback']}'"
              if e["fallback"] else " (the bit-identity oracle)")
        print(f"  {e['name']}{tag}: {e['launches']}{fb}")
        print(f"      {e['description']}")
        for eng, cell in e["engines"].items():
            mark = "supported" if cell["supported"] else "degrades"
            print(f"      [{eng}] {mark}: {cell['detail']}")
        # an unsupported backend cell's detail is the fallback reason the
        # engine stamps into stats['device']['fallback']
        for be, cell in e["backends"].items():
            mark = "native" if cell["supported"] else "degrades"
            print(f"      [backend {be}] {mark}: {cell['detail']}")
    return 0


def _analyze(args) -> int:
    """`cli analyze`: the models' encoding and action passes, then the
    engine sources' ownership and purity passes.  Exit 0 with no HIGH
    finding, 1 with one, 2 when a target cannot be analyzed."""
    from .analysis import Finding, analysis_record, analyze_engine_sources, repo_root

    findings = []
    targets = []
    rc_error = 0
    if not args.no_models:
        from .analysis.encoding import analyze_model
        from .models.base import EncodingUnsound

        cfg_paths = list(args.cfgs)
        if args.module and len(cfg_paths) != 1:
            # --module pairs with exactly one .cfg (the default matrix
            # resolves its own modules)
            print("error: --module requires exactly one .cfg argument "
                  f"(got {len(cfg_paths)})", file=sys.stderr)
            return EXIT_ERROR
        if not cfg_paths:
            cfg_paths = sorted(str(p) for p in Path(repo_root(), "configs").glob("*.cfg"))
        # stems that are not module names
        aliases = {"Kip320Stretch": "Kip320"}
        for path in cfg_paths:
            stem = Path(path).stem
            module = args.module or aliases.get(stem, stem)
            targets.append(f"{module} ({path})")
            try:
                # the gate raises on the FIRST HIGH finding; here every
                # finding is wanted
                model = build_model(module, parse_cfg(path), analysis_gate=False)
            except EncodingUnsound as e:
                findings.extend(e.findings)
                continue
            except (OSError, ValueError, KeyError) as e:
                # the record says so too: a consumer keying off `ok` must
                # never read a partly analyzed matrix as clean
                findings.append(Finding(
                    kind="analysis-error", severity="HIGH",
                    target=f"{module} ({path})",
                    message=f"cannot analyze: {e}",
                    data={"path": str(path), "module": module},
                ))
                print(f"error: cannot analyze {path}: {e}", file=sys.stderr)
                rc_error = EXIT_ERROR
                continue
            findings.extend(analyze_model(model))
    if not args.no_engine:
        targets.append("engine sources (ownership + purity)")
        findings.extend(analyze_engine_sources())
        # the trace vocabulary (obs/fleettrace registries): every span or
        # event kind the port emits must be registered and documented
        targets.append("trace vocabulary (obs/fleettrace registries)")
        from .obs.fleettrace import lint_trace_vocabulary

        for prob in lint_trace_vocabulary():
            findings.append(Finding(
                kind="trace-vocab", severity="HIGH",
                target=f"{prob['path']}:{prob['line']}",
                message=prob["problem"],
                data=dict(prob),
            ))
        # the durable-write discipline: every rename/replace and append
        # journal goes through durable_io (or a registered emitter), so
        # that crashcheck records it
        targets.append("durable-write discipline (durable_io boundary)")
        from .analysis.durable_lint import lint_durable_io

        for prob in lint_durable_io():
            findings.append(Finding(
                kind="durable-io", severity="HIGH",
                target=f"{prob['path']}:{prob['line']}",
                message=prob["problem"],
                data=dict(prob),
            ))
        # the raw-clock discipline: every timing decision of a
        # clock-migrated module goes through utils/clock.py, so that the
        # simfleet virtual clock owns it
        targets.append("raw-clock discipline (utils/clock boundary)")
        from .analysis.clock_lint import lint_raw_clock

        for prob in lint_raw_clock():
            findings.append(Finding(
                kind="raw-clock", severity="HIGH",
                target=f"{prob['path']}:{prob['line']}",
                message=prob["problem"],
                data=dict(prob),
            ))
    rec = analysis_record(findings, targets=targets)
    if args.json:
        print(json.dumps(rec))
    else:
        c = rec["counts"]
        print(f"kspec analyze: {len(targets)} target(s) — "
              f"{c['HIGH']} high / {c['MEDIUM']} medium / {c['LOW']} low / "
              f"{c['INFO']} info")
        shown = [f for f in findings if args.info or f.severity != "INFO"]
        for f in shown:
            tag = f" [suppressed: {f.suppressed}]" if f.suppressed else ""
            print(f"  {f.severity:<6} {f.kind:<24} {f.target}{tag}")
            print(f"         {f.message}")
        if not shown:
            print("  clean: encoding sound, frames honored, ownership "
                  "contracts verified")
    if rc_error:
        return rc_error
    return 0 if rec["ok"] else 1


def _service_dir(given) -> str:
    return given or os.environ.get("KSPEC_SERVICE_DIR", "service")


def _serve(args, argv) -> int:
    """`serve`: the daemon in this process, or (--supervised) this command
    less --supervised as the supervisor's child."""
    svc_dir = _service_dir(args.service_dir)
    if args.supervised:
        from .resilience.supervisor import daemon_supervisor_config, supervise

        child_argv = [a for a in argv
                      if not (a.startswith("--su") and "--supervised".startswith(a))]
        cfg = daemon_supervisor_config(
            svc_dir,
            [sys.executable, "-m", "kafka_specification_tpu_torch.cli"] + child_argv,
            stall_timeout=args.stall_timeout,
            max_restarts=args.max_restarts,
        )
        return supervise(cfg)
    from .service.daemon import Daemon, ServeConfig

    try:
        daemon = Daemon(ServeConfig(
            service_dir=svc_dir,
            poll_s=args.poll,
            max_jobs=args.max_jobs,
            idle_exit_s=args.idle_exit,
            min_bucket=args.min_bucket,
            chunk_size=args.chunk_size,
            visited_backend=args.visited_backend,
            device="cpu" if args.cpu else args.device,
            cache_entries=args.cache_entries,
            batching=not args.no_batching,
            state_cache=not args.no_state_cache,
            state_cache_dir=args.state_cache_dir,
        ))
    except (RuntimeError, ValueError) as e:
        # no card (and no --cpu), or a daemon fault plan naming an unwired
        # site: refused before any job is claimed
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    return daemon.serve()


def _run_service_client(args) -> int:
    """submit / status / result: the tenants' side of the service, on one
    service directory or (``--router``) through a routed fleet.  Only
    torch-free imports here."""
    from .service.queue import JobQueue
    from .verdict import render_verdict

    router = None
    q = None
    if getattr(args, "router", None):
        # the cross-host router (torch-free): placement and the tenant's
        # fleet-wide max_pending cap live inside Router.submit
        from .service.router import Router

        try:
            router = Router(args.router)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
    else:
        try:
            # submit creates the tree (tenants may enqueue before the
            # first daemon starts); status/result are read-only, so a
            # mistyped --service-dir is an error, not a new empty service
            q = JobQueue(_service_dir(args.service_dir), create=args.cmd == "submit")
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR

    if args.cmd == "submit":
        try:
            cfg_text = Path(args.cfg).read_text()
        except OSError as e:
            print(f"error: cannot read {args.cfg}: {e}", file=sys.stderr)
            return EXIT_ERROR
        module = args.module or Path(args.cfg).stem
        try:
            parse_cfg(cfg_text)  # validate before queueing
        except ValueError as e:
            print(f"error: cannot parse {args.cfg}: {e}", file=sys.stderr)
            return EXIT_ERROR
        if args.hand and args.emitted:
            print("error: --hand and --emitted are mutually exclusive", file=sys.stderr)
            return EXIT_ERROR
        if args.fault:
            try:
                FaultPlan(args.fault)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return EXIT_ERROR
        if router is None:
            # admission control: the tenant's max_pending cap (advisory:
            # the check is client-side, so a racing burst can overshoot;
            # the budget that matters, the resource governor, is the
            # daemon's).  With --router it is Router.submit's, fleet-wide
            from .resilience.resources import budget_for_tenant, load_tenant_budgets

            try:
                budgets = load_tenant_budgets(q.tenants_path)
            except (OSError, ValueError) as e:
                print(f"error: bad tenants.json: {e}", file=sys.stderr)
                return EXIT_ERROR
            b = budget_for_tenant(budgets, args.tenant)
            if b is not None and b.max_pending is not None:
                mine = q.pending_for_tenant(args.tenant, stop_at=b.max_pending)
                if mine >= b.max_pending:
                    print(f"error: tenant {args.tenant!r} at max_pending={b.max_pending} "
                          f"({mine} queued) — drain or raise the cap in tenants.json",
                          file=sys.stderr)
                    return EXIT_ERROR
        kernel_source = "emitted" if args.emitted else "hand" if args.hand else "auto"
        try:
            # transient queue-dir errors are retried with bounded backoff
            # inside JobQueue.submit; only a persistent failure lands here
            spec = (router or q).submit(cfg_text, module, tenant=args.tenant,
                                        cfg_path=args.cfg, kernel_source=kernel_source,
                                        max_depth=args.max_depth,
                                        max_states=args.max_states, fault=args.fault)
        except OSError as e:
            where = router.dir if router is not None else q.dir
            print(f"error: cannot publish job to {where!r} after retries: {e}",
                  file=sys.stderr)
            return EXIT_ERROR
        except RuntimeError as e:
            # AdmissionDenied: the router's fleet-wide tenant cap
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        where = (f"host{spec['host']} ({router.hosts[spec['host']]})"
                 if router is not None else q.dir)
        if args.json and not args.wait:
            out = {"job_id": spec["job_id"]}
            if router is not None:
                out["host"] = spec["host"]
                out["service_dir"] = router.hosts[spec["host"]]
            else:
                out["service_dir"] = q.dir
            print(json.dumps(out))
        else:
            print(f"submitted {spec['job_id']} (tenant {args.tenant}) -> {where}",
                  file=sys.stderr)
        if not args.wait:
            if not args.json:
                print(spec["job_id"])
            return 0
        rec = (router or q).wait_result(spec["job_id"], timeout=args.timeout)
        if rec is None:
            hint = (f"`cli route {router.dir} --status`" if router is not None
                    else f"`cli serve {q.dir}`")
            print(f"error: no verdict for {spec['job_id']} within {args.timeout}s "
                  f"(is the daemon up?  {hint})", file=sys.stderr)
            return EXIT_ERROR
        print(json.dumps(rec) if args.json else render_verdict(rec))
        return verdict_exit_code(rec)

    if args.cmd == "status":
        if args.job_id is None:
            ov = (router or q).overview()
            if args.json:
                print(json.dumps(ov))
            elif router is not None:
                print(f"router {ov['dir']}: {len(ov['hosts'])} hosts, "
                      f"{ov['routes']} routed jobs")
                for h in ov["hosts"]:
                    print(f"  host{h['host']} [{h['state']:>6}] {h['dir']}: "
                          f"{h['pending']} pending, {h['claimed']} in flight")
            else:
                c = ov["counts"]
                print(f"service {ov['dir']}: {c['pending']} pending, "
                      f"{c['claimed']} in flight, {c['done']} done")
                for jid in ov["recent_done"]:
                    rec = q.result(jid) or {}
                    print(f"  {jid}  {rec.get('status', '?')}")
            return 0
        st = (router or q).status(args.job_id)
        if args.json:
            print(json.dumps(st))
        else:
            line = f"{st['job_id']}: {st['state']}"
            if st.get("host") is not None:
                line += f" @ host{st['host']}"
            rec = st.get("result")
            if rec:
                line += f" ({rec.get('status', '?')})"
            print(line)
        return 0 if st["state"] != "unknown" else 1

    # result
    rec = ((router or q).wait_result(args.job_id, timeout=args.timeout) if args.wait
           else (router or q).result(args.job_id))
    if rec is None:
        print(f"error: no verdict for {args.job_id}"
              + ("" if args.wait else " (yet — use --wait)"), file=sys.stderr)
        return EXIT_ERROR
    print(json.dumps(rec) if args.json else render_verdict(rec))
    return verdict_exit_code(rec)


def _serve_fleet(args) -> int:
    """`serve-fleet`: the torch-free fleet parent over N `cli serve`
    children (service/fleet.py).  The device flags pass through."""
    from .service.fleet import FleetServeConfig, serve_fleet_daemons

    serve_args = [
        "--min-bucket", str(args.min_bucket),
        "--chunk-size", str(args.chunk_size),
        "--visited-backend", args.visited_backend,
        "--cache-entries", str(args.cache_entries),
    ]
    if args.no_batching:
        serve_args.append("--no-batching")
    if args.no_state_cache:
        serve_args.append("--no-state-cache")
    if args.cpu:
        serve_args.append("--cpu")
    elif args.device:
        serve_args += ["--device", args.device]
    daemons = max(1, args.daemons)
    return serve_fleet_daemons(FleetServeConfig(
        service_dir=_service_dir(args.service_dir),
        daemons=daemons,
        min_daemons=daemons if args.min_daemons is None else max(1, args.min_daemons),
        max_daemons=args.max_daemons,
        poll_s=args.poll,
        stall_timeout=args.stall_timeout,
        max_restarts=args.max_restarts,
        backoff_base=args.backoff_base,
        scale_interval_s=args.scale_interval,
        scale_up_pending=args.scale_up_pending,
        scale_down_idle_s=args.scale_down_idle,
        serve_args=tuple(serve_args),
        state_cache_dir=args.state_cache_dir,
        host_instance=args.host_instance,
    ))


def _run_router(args) -> int:
    """`cli route`: cross-host placement and dead-host recovery, torch-free
    (it runs on the operator's box, often while a host is down)."""
    from .service.router import Router

    try:
        router = Router(args.router_dir, hosts=args.hosts, dead_after_s=args.dead_after)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR

    if args.status:
        ov = router.overview()
        if args.json:
            print(json.dumps(ov))
        else:
            print(f"router {ov['dir']}: {len(ov['hosts'])} hosts, "
                  f"{ov['routes']} routed jobs, dead after "
                  f"{ov['dead_after_s']}s (+{ov['clock_skew_s']}s skew)")
            for h in ov["hosts"]:
                age = h["hb_age_s"]
                age_s = "never" if age is None else f"{age:.1f}s ago"
                print(f"  host{h['host']} [{h['state']:>6}] {h['dir']}: "
                      f"{h['pending']} pending, {h['claimed']} in flight, "
                      f"heartbeat {age_s}")
        return 0

    if args.once:
        out = router.sweep()
        if args.json:
            print(json.dumps(out))
        else:
            dead = [h["host"] for h in out["hosts"] if h["state"] == "dead"]
            took = sum(len(v) for v in out["takeover"].values())
            moved = sum(len(v) for v in out["rerouted"].values())
            print(f"sweep: {len(dead)} dead hosts"
                  + (f" ({', '.join(f'host{i}' for i in dead)})" if dead else "")
                  + f", {took} claims taken over, {moved} pending jobs re-routed")
        return 0

    print(f"router serving {len(router.hosts)} hosts from {router.dir} "
          f"(poll {args.poll}s)", file=sys.stderr)
    import signal

    signal.signal(signal.SIGTERM, lambda *_: router.request_stop())
    try:
        router.serve(poll_s=args.poll)
    except KeyboardInterrupt:
        pass
    return 0


def _run_fleet_obs(args) -> int:
    """`cli trace|top|fleet-report`: the fleet trace plane's read side
    (obs/fleettrace.py), torch-free: everything renders from side-channel
    files."""
    import time

    from .obs import fleettrace as ft

    router_dir = getattr(args, "router", None)
    if router_dir:
        from .service.router import Router

        try:
            router = Router(router_dir)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        roots = [router.dir] + [q.dir for q in router.queues]
        host_roots = [q.dir for q in router.queues]
    else:
        host_roots = [os.path.normpath(d)
                      for d in (getattr(args, "service_dir", None) or [_service_dir(None)])]
        roots = host_roots

    if args.cmd == "trace":
        recs = ft.load_trace(roots, args.job_id)
        if not recs:
            print(f"no trace for job {args.job_id} under " + ", ".join(roots),
                  file=sys.stderr)
            return 1
        data = ft.assemble(recs, job_id=args.job_id)
        print(json.dumps(data, default=str) if args.json else ft.render_trace(data))
        return 0

    if args.cmd == "fleet-report":
        data = ft.fleet_report_data(roots, exemplars=args.exemplars)
        print(json.dumps(data, default=str) if args.json
              else ft.render_fleet_report(data))
        return 0

    # top: one frame under --once/--json, else redraw until interrupted
    if args.json:
        print(json.dumps(ft.top_data(host_roots, router_dir=router_dir), default=str))
        return 0
    try:
        while True:
            frame = ft.render_top(ft.top_data(host_roots, router_dir=router_dir))
            if args.once:
                print(frame)
                return 0
            # whole-frame redraw: clear + home, then the frame
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def _run_sweep(args) -> int:
    """`cli sweep plan|run|report|bisect` (sweep/): a queue/router client;
    the daemons do the engine work.  Only `plan` imports torch (its
    vacuity pass, on the CPU)."""
    from .sweep.lattice import load_lattice
    from .sweep.portfolio import SweepConfig, load_manifest

    if args.sweep_cmd == "plan":
        from .sweep.portfolio import plan_sweep

        try:
            lattice = load_lattice(args.lattice)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        cfg = SweepConfig(
            sweep_dir=".",  # plan never writes
            service_dir=_service_dir(getattr(args, "service_dir", None)),
            state_cache_dir=args.state_cache_dir,
        )
        plan = plan_sweep(lattice, cfg)
        if args.json:
            print(json.dumps({
                "lattice": lattice.record(),
                "points": len(plan["points"]),
                "runnable": len(plan["runnable"]),
                "deferred": len(plan["deferred"]),
                "skipped": [{"point": p.record(), "findings": p.vacuous}
                            for p in plan["skipped"]],
                "cost_model": plan["model"].to_dict(),
                "predictions": plan["predictions"],
            }))
            return 0
        m = plan["model"]
        total_states = sum(plan["predictions"][p.point_id]["states"]
                           for p in plan["runnable"] + plan["deferred"])
        total_s = sum(plan["predictions"][p.point_id]["seconds"] or 0.0
                      for p in plan["runnable"] + plan["deferred"])
        print(f"lattice {lattice.name}: {len(plan['points'])} points "
              f"({len(plan['runnable'])} runnable, "
              f"{len(plan['deferred'])} deferred, "
              f"{len(plan['skipped'])} skipped as statically vacuous)")
        print(f"cost model: {m.n_records} corpus records, predicted "
              f"~{total_states} states, ~{total_s:.1f}s engine wall "
              "(flat-throughput; honesty limits in docs/sweep.md)")
        for p in plan["skipped"][:8]:
            acts = ", ".join(f.get("target", "?") for f in p.vacuous[:3])
            print(f"  skipped: vacuous {dict(p.coords)} [{acts}]")
        if len(plan["skipped"]) > 8:
            print(f"  ... and {len(plan['skipped']) - 8} more")
        return 0

    if args.sweep_cmd == "run":
        from .sweep.portfolio import run_sweep

        try:
            lattice = load_lattice(args.lattice)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        cfg = SweepConfig(
            sweep_dir=args.sweep_dir,
            service_dir=None if args.router else _service_dir(args.service_dir),
            router_dir=args.router,
            tenant=args.tenant,
            max_inflight=args.max_inflight,
            solo_threshold_states=args.solo_threshold,
            wait_timeout_s=args.timeout,
            state_cache_dir=args.state_cache_dir,
        )
        rec = run_sweep(lattice, cfg, log=lambda s: print(s))
        if args.json:
            print(json.dumps(rec))
        incomplete = sum(1 for row in rec["points"].values()
                         if row.get("status") in ("pending", "submitted"))
        errors = sum(1 for row in rec["points"].values() if row.get("status") == "error")
        return 1 if errors else (EXIT_RESOURCE_EXHAUSTED if incomplete else 0)

    if args.sweep_cmd == "report":
        from .obs.report import render_sweep_report, sweep_report_data

        try:
            data = sweep_report_data(args.sweep_dir)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return EXIT_ERROR
        print(json.dumps(data) if args.json else render_sweep_report(data))
        return 0

    # bisect: witness the frontier (runs neighbors through the service)
    from .sweep.bisect import refine_frontier
    from .sweep.lattice import enumerate_points
    from .sweep.portfolio import Dispatcher

    try:
        man = load_manifest(args.sweep_dir)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR
    if args.service_dir or args.router:
        dispatch = Dispatcher(SweepConfig(
            sweep_dir=args.sweep_dir,
            service_dir=None if args.router else _service_dir(args.service_dir),
            router_dir=args.router,
            tenant=args.tenant,
        ))

        def runner(coords):
            # synthesize the probe point by re-enumerating the lattice
            # restricted to these coordinates: the same canonical keys,
            # so the probe may itself be a state-cache hit
            want = dict(coords)
            for p in enumerate_points(load_lattice(dict(man["lattice"]))):
                if dict(p.coords) == want:
                    jid = (f"probe-{man['sweep_id']}-"
                           f"{p.point_id.replace(':', '-')}-{os.urandom(2).hex()}")
                    dispatch.submit(p, jid, solo=True)
                    return dispatch.backend.wait_result(jid, timeout=args.timeout) or {}
            return {}
    else:

        def runner(coords):
            return {}  # manifest-only mode: unknown neighbors stay unrun

    out = refine_frontier(man, runner, log=lambda s: print(s, file=sys.stderr),
                          invariant=args.invariant, max_probes=args.max_probes)
    if args.json:
        print(json.dumps(out))
        return 0
    if not out:
        print("no violating points in the manifest — nothing to bisect")
        return 0
    for inv in sorted(out):
        rep = out[inv]
        print(f"{inv}: frontier of {len(rep['frontier'])} minimal "
              f"violating configs ({len(rep['witnesses'])} neighbors "
              f"witnessed, {len(rep['demoted'])} claims demoted)")
        for r in rep["frontier"]:
            coords = r.get("coords")
            print(f"  {dict(coords) if coords else r.get('_indices')}")
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
    pc.add_argument("--sharded", action="store_true", help="mesh-sharded engine")
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
        "--integrity-shadow",
        type=float,
        metavar="RATE",
        help="sampled shadow re-execution rate in [0,1] "
        "(KSPEC_INTEGRITY_SHADOW is the env twin): deterministically "
        "sampled chunks have their emitted rows fingerprinted again on the "
        "host (the numpy twin of the fingerprint kernel) and held against "
        "the kernel's result bit for bit; a mismatch exits typed "
        f"INTEGRITY_VIOLATION (code {EXIT_INTEGRITY}).  The per-level "
        "digest chain and storage read-side checksums are always on "
        "regardless (KSPEC_INTEGRITY=0 disables both)",
    )
    pc.add_argument(
        "--resilient",
        action="store_true",
        help="run under the auto-resume supervisor: spawn the check as a "
        "child, watch the --stats heartbeat, kill on stall, restart from "
        "--checkpoint with a bounded budget (scripts/torch_resilient_run.py "
        "is the standalone form)",
    )
    pc.add_argument(
        "--stall-timeout",
        type=float,
        default=1800.0,
        help="[--resilient] kill the child after this many seconds "
        "without heartbeat growth (default 1800)",
    )
    pc.add_argument(
        "--max-restarts",
        type=int,
        default=8,
        help="[--resilient] restart budget (default 8)",
    )
    pc.add_argument(
        "--events",
        help="[--resilient] supervisor JSONL event log (default: "
        "<run dir>/events.jsonl)",
    )
    pc.add_argument(
        "--reclaim",
        action="store_true",
        help="[--resilient] on a RESOURCE_EXHAUSTED child exit, prune "
        "stale tmp files + rotated checkpoint generations and retry "
        "exactly once (default: halt with an actionable verdict; the "
        "supervisor never restarts into an unreclaimed full disk)",
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
        "--overlap",
        choices=["on", "off"],
        default=None,
        help="async level-pipelined execution ($KSPEC_OVERLAP is the env twin; "
        "default on): the two-slot staged chunk pipeline (a chunk's host commit "
        "runs while the next chunk's kernels finish), background spill-run "
        "merges, and checkpoint writes on a writer thread.  'off' is the serial "
        "path (the bit-identity oracle): counts, traces and digest chains are "
        "identical either way",
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
    pcc = sub.add_parser(
        "crashcheck",
        help="crash-consistency torture harness: record every durable "
        "filesystem op each recovery protocol issues, enumerate every legal "
        "post-crash state (torn writes, reverted renames, lost journal "
        "tails), and run the protocol's own recovery against each one; "
        "imports no torch.  Exits 1 on any non-convergent state; findings "
        "carry the op-log prefix and crash state as a machine-readable "
        "repro.  --json prints the kspec-crashcheck/1 record",
    )
    pcc.add_argument("--protocol", action="append", dest="protocols", metavar="P",
                     help="restrict to one protocol or scenario name (repeatable; "
                     "see `cli faults --list` for the scenario registry)")
    pcc.add_argument("--json", action="store_true",
                     help="machine-readable kspec-crashcheck/1 record")
    psf = sub.add_parser(
        "simfleet",
        help="deterministic fleet simulation: run the real router, queue, "
        "daemon and cache control plane under a virtual clock and a seeded "
        "scheduler, search interleavings across seeds (kill, partition, "
        "clock skew, flaky fs), judge every run with invariant oracles, and "
        "shrink any violation to a minimal kspec-simfleet/1 repro; imports "
        "no torch.  `run` exits 1 on any violation; `replay` re-runs a "
        "repro and exits 0 if it still reproduces, 2 if stale",
    )
    sfsub = psf.add_subparsers(dest="sf_cmd", required=True)
    psr = sfsub.add_parser("run", help="sweep seeds, shrink violations")
    psr.add_argument("--seeds", type=int, default=50,
                     help="how many seeds to run (default 50)")
    psr.add_argument("--start-seed", type=int, default=0, help="first seed (default 0)")
    psr.add_argument("--hosts", type=int, default=2)
    psr.add_argument("--jobs", type=int, default=4)
    psr.add_argument("--steps", type=int, default=60,
                     help="schedule length per seed (default 60)")
    psr.add_argument("--coverage", action="store_true",
                     help="coverage-guided: seeds that reach new adjacent event-type "
                     "pairs queue derived seeds behind them")
    psr.add_argument("--out", default="simfleet-repros", metavar="DIR",
                     help="directory violations' shrunk repros are banked in "
                     "(default ./simfleet-repros)")
    psr.add_argument("--json", action="store_true")
    psp = sfsub.add_parser("replay", help="replay a kspec-simfleet/1 repro")
    psp.add_argument("repro", help="kspec-simfleet/1 file")
    psp.add_argument("--trace", action="store_true",
                     help="assemble the violating job's fleet trace from the simulated "
                     "run and render the same waterfall `cli trace` gives real runs")
    psp.add_argument("--json", action="store_true")
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
    po = sub.add_parser("oracle", help="run the Python reference interpreter (on the host)")
    po.add_argument("cfg")
    po.add_argument("--module", help="TLA+ module (default: cfg file stem)")
    po.add_argument("--max-depth", type=int)
    po.add_argument("--max-states", type=int)
    pp = sub.add_parser(
        "pipelines",
        help="enumerate the registered level pipelines (the --pipeline / "
        "$KSPEC_PIPELINE registry, pipeline_registry.py) with their launches, "
        "degradation ladder and per-engine and per-backend support; touches no card",
    )
    pp.add_argument("--list", action="store_true", dest="list_pipelines",
                    help="list the pipeline registry (the default action)")
    pp.add_argument("--json", action="store_true")
    pan = sub.add_parser(
        "analyze",
        help="static analysis of the specs and the engine: encoding-soundness "
        "proofs (interval abstract interpretation of every action kernel "
        "against its packed field ranges), action/guard lint (vacuous guards, "
        "frame violations, dead fields), and the ownership and purity checks "
        "over the port's engine sources.  Touches no card.  Exits non-zero on "
        "any HIGH finding; --json prints the kspec-analysis/1 record",
    )
    pan.add_argument("cfgs", nargs="*",
                     help="TLC .cfg files to analyze (default: every configs/*.cfg)")
    pan.add_argument("--module", help="TLA+ module for a single .cfg (default: the cfg stem)")
    pan.add_argument("--no-models", action="store_true",
                     help="skip the per-model encoding/lint passes")
    pan.add_argument("--no-engine", action="store_true",
                     help="skip the engine ownership/purity passes")
    pan.add_argument("--info", action="store_true",
                     help="also print INFO findings (suppressions, skips)")
    pan.add_argument("--json", action="store_true",
                     help="machine-readable kspec-analysis/1 record")

    # --- checking-as-a-service (service/): the JAX package's verbs --------
    svc_help = ("service directory (queue + results + run dirs; default: "
                "$KSPEC_SERVICE_DIR or ./service)")
    pserve = sub.add_parser(
        "serve",
        help="run the serving daemon: import torch once, hold built models in a "
        "shape-keyed cache, drain the durable job queue on the card under "
        "per-tenant resource budgets, coalesce jobs sharing a schema shape into "
        "one batched engine run, and serve repeat checks from the state-space cache",
    )
    pserve.add_argument("service_dir", nargs="?", help=svc_help)
    pserve.add_argument("--poll", type=float, default=0.2,
                        help="queue poll interval seconds (default 0.2)")
    pserve.add_argument("--max-jobs", type=int,
                        help="exit after this many verdicts (benchmarks / tests)")
    pserve.add_argument("--idle-exit", type=float,
                        help="exit after this many seconds with an empty queue "
                        "(default: serve forever)")
    pserve.add_argument("--min-bucket", type=int, default=256)
    pserve.add_argument(
        "--chunk-size", type=int, default=32768,
        help="engine streaming chunk (one value for the whole daemon: batched "
        "verdict derivation depends on chunk boundaries)",
    )
    pserve.add_argument("--visited-backend", choices=list(VISITED_BACKENDS),
                        default="device")
    pserve.add_argument("--no-batching", action="store_true",
                        help="disable multi-config coalescing (every job runs solo)")
    pserve.add_argument("--cache-entries", type=int, default=32,
                        help="model-cache LRU capacity (distinct schema shapes held "
                        "warm; default 32)")
    pserve.add_argument(
        "--supervised", action="store_true",
        help="run the daemon under the auto-restart supervisor (heartbeat "
        "stall-kill + bounded restarts; resilience/supervisor.py)",
    )
    pserve.add_argument(
        "--stall-timeout", type=float, default=120.0,
        help="[--supervised] kill the daemon after this many seconds without a "
        "heartbeat tick (default 120)",
    )
    pserve.add_argument("--max-restarts", type=int, default=8,
                        help="[--supervised] restart budget (default 8)")
    pserve.add_argument(
        "--no-state-cache", action="store_true",
        help="disable the persistent state-space cache (default on: repeat checks "
        "of an unchanged config become chain-verified cache hits, config-delta "
        "checks seed from the cached boundary; every artifact problem degrades "
        "to a cold run with a typed cache-fallback event)",
    )
    pserve.add_argument(
        "--state-cache-dir", metavar="DIR",
        help="state-space cache root (default: <service_dir>/state-cache); "
        "entries are content-addressed and verified on every read, so daemons "
        "of either package may share one",
    )
    pserve.add_argument("--cpu", action="store_true",
                        help="run the jobs on the CPU (the same as --device cpu)")
    pserve.add_argument("--device", default=None,
                        help="torch device for the jobs (default: the card, cuda)")

    psub = sub.add_parser(
        "submit",
        help="submit a check to the service queue and print the job id; never "
        "imports torch (the .cfg travels inline in the job spec)",
    )
    psub.add_argument("cfg")
    psub.add_argument("--module", help="TLA+ module (default: cfg stem)")
    psub.add_argument("--service-dir", help=svc_help)
    psub.add_argument(
        "--router", metavar="DIR",
        help="submit through a cross-host router directory (`cli route`) instead "
        "of a single service dir: the router places the job on the healthiest "
        "live host and enforces the tenant's max_pending cap fleet-wide")
    psub.add_argument("--tenant", default="default")
    psub.add_argument("--max-depth", type=int)
    psub.add_argument("--max-states", type=int)
    psub.add_argument("--emitted", action="store_true", default=None,
                      help="ask for the mechanically emitted kernels (a daemon of "
                      "the port answers such a job with an error verdict)")
    psub.add_argument("--hand", action="store_true",
                      help="force the hand-written kernels")
    psub.add_argument("--fault", metavar="PLAN",
                      help="deterministic fault plan for THIS job (the daemon "
                      "scopes it to the job's run)")
    psub.add_argument("--wait", action="store_true",
                      help="block until the verdict and exit with its exit code")
    psub.add_argument("--timeout", type=float, default=300.0,
                      help="[--wait] give up after this many seconds (default 300)")
    psub.add_argument("--json", action="store_true")

    pst = sub.add_parser(
        "status",
        help="job state (pending/claimed/done) or, with no job id, the queue "
        "overview; never imports torch",
    )
    pst.add_argument("job_id", nargs="?")
    pst.add_argument("--service-dir", help=svc_help)
    pst.add_argument(
        "--router", metavar="DIR",
        help="resolve the job through a router directory (locates the host it "
        "was routed to, following reroutes)")
    pst.add_argument("--json", action="store_true")

    pres = sub.add_parser(
        "result",
        help="fetch a job's verdict (kspec-verdict/1, the record `cli check "
        "--json` prints) and exit with its exit code; never imports torch",
    )
    pres.add_argument("job_id")
    pres.add_argument("--service-dir", help=svc_help)
    pres.add_argument(
        "--router", metavar="DIR",
        help="fetch the verdict through a router directory (the routed host "
        "first, then every host: a rerouted job's verdict is found wherever it "
        "landed)")
    pres.add_argument("--wait", action="store_true", help="block until the verdict exists")
    pres.add_argument("--timeout", type=float, default=300.0)
    pres.add_argument("--json", action="store_true")

    pfleet = sub.add_parser(
        "serve-fleet",
        help="run an N-daemon serving fleet over one service directory: "
        "per-daemon heartbeat supervision (death/wedge/rc-75/rc-76 taxonomy, "
        "bounded jittered restarts), queue-depth autoscaling between "
        "--min/--max with graceful drain, lease-based takeover of a dead or "
        "wedged daemon's claims.  The parent never imports torch; each daemon "
        "runs on the card unless --cpu",
    )
    pfleet.add_argument("service_dir", nargs="?", help=svc_help)
    pfleet.add_argument("--daemons", type=int, default=2,
                        help="initial fleet size (default 2)")
    pfleet.add_argument("--min", type=int, default=None, dest="min_daemons",
                        help="autoscale floor (default: --daemons)")
    pfleet.add_argument("--max", type=int, default=None, dest="max_daemons",
                        help="autoscale ceiling (default: --daemons)")
    pfleet.add_argument("--poll", type=float, default=0.5)
    pfleet.add_argument(
        "--stall-timeout", type=float, default=120.0,
        help="kill + restart a daemon whose own heartbeat file freezes for this "
        "long (an idle daemon still ticks every few seconds, so frozen means "
        "wedged; default 120)",
    )
    pfleet.add_argument("--max-restarts", type=int, default=8,
                        help="per-daemon restart budget (default 8)")
    pfleet.add_argument("--backoff-base", type=float, default=1.0)
    pfleet.add_argument("--scale-up-pending", type=int, default=4,
                        help="pending jobs per live daemon that triggers a "
                        "scale-up (default 4)")
    pfleet.add_argument("--scale-interval", type=float, default=5.0)
    pfleet.add_argument(
        "--scale-down-idle", type=float, default=60.0,
        help="seconds of empty queue before one daemon is gracefully drained "
        "(finishes claimed jobs, takes no new ones, exits 0; default 60)",
    )
    pfleet.add_argument("--min-bucket", type=int, default=256)
    pfleet.add_argument("--chunk-size", type=int, default=32768)
    pfleet.add_argument("--visited-backend", choices=list(VISITED_BACKENDS),
                        default="device")
    pfleet.add_argument("--no-batching", action="store_true")
    pfleet.add_argument("--cache-entries", type=int, default=32)
    pfleet.add_argument("--no-state-cache", action="store_true")
    pfleet.add_argument(
        "--state-cache-dir", metavar="DIR",
        help="shared state-space cache root for every daemon (see `serve "
        "--state-cache-dir`; point several hosts' fleets at one directory to "
        "federate the cache)",
    )
    pfleet.add_argument(
        "--host-instance", type=int, metavar="I",
        help="this fleet's host index in a cross-host deployment (exported as "
        "KSPEC_HOST_INSTANCE to every daemon; scopes host-targeted faults like "
        "kill@host<i> and skew@host<i>)",
    )
    pfleet.add_argument("--cpu", action="store_true",
                        help="run every daemon on the CPU (the same as --device cpu)")
    pfleet.add_argument("--device", default=None,
                        help="torch device for every daemon (default: the card, cuda)")

    proute = sub.add_parser(
        "route",
        help="run the cross-host router over N per-host service directories: "
        "health-aware placement (heartbeat freshness, queue depth), fleet-wide "
        "tenant admission, dead-host detection with exactly-once re-routing of "
        "pending jobs to survivors; never imports torch",
    )
    proute.add_argument("router_dir",
                        help="router state directory (created on first run; holds "
                        "router.json, route records, and the router event log)")
    proute.add_argument("--hosts", nargs="+", metavar="DIR",
                        help="per-host service directories to front (required on "
                        "first run; persisted in router.json and optional afterwards)")
    proute.add_argument("--dead-after", type=float, default=None,
                        help="seconds without a daemon heartbeat before a host is "
                        "declared dead and its pending jobs re-route (default 30; "
                        "the comparison tolerates KSPEC_CLOCK_SKEW)")
    proute.add_argument("--poll", type=float, default=1.0,
                        help="sweep interval seconds (default 1.0)")
    proute.add_argument("--once", action="store_true",
                        help="run a single sweep (takeover + re-route pass) and exit")
    proute.add_argument("--status", action="store_true",
                        help="print per-host health and queue depths, run no sweep")
    proute.add_argument("--json", action="store_true")

    ptr = sub.add_parser(
        "trace",
        help="render one job's fleet-wide trace (submit -> placement -> claim "
        "-> run -> publish) as a skew-normalized cross-host span waterfall with "
        "the typed stage decomposition; never imports torch",
    )
    ptr.add_argument("job_id")
    ptr.add_argument("--service-dir", action="append", metavar="DIR",
                     help="service root(s) whose traces/ to read (repeatable; "
                     "default: $KSPEC_SERVICE_DIR or ./service)")
    ptr.add_argument("--router", metavar="DIR",
                     help="read the router dir's traces/ plus every fronted host's "
                     "(a re-routed job's spans live on both sides)")
    ptr.add_argument("--json", action="store_true")

    ptop = sub.add_parser(
        "top",
        help="live fleet view from on-disk state only: queue depths, daemon "
        "heartbeats, per-stage p50/p95, cache hit ratio, sweep progress; never "
        "imports torch",
    )
    ptop.add_argument("--service-dir", action="append", metavar="DIR",
                      help="service root(s) to watch (repeatable)")
    ptop.add_argument("--router", metavar="DIR",
                      help="watch every host behind a router directory")
    ptop.add_argument("--once", action="store_true", help="print one frame and exit")
    ptop.add_argument("--interval", type=float, default=2.0,
                      help="refresh seconds (default 2.0)")
    ptop.add_argument("--json", action="store_true",
                      help="print one JSON frame and exit (implies --once)")

    pfr = sub.add_parser(
        "fleet-report",
        help="SLO artifact over every completed trace: per-stage latency "
        "percentiles (p50/p95), cache hit ratio, slowest-job exemplars, chaos "
        "annotations (re-routes, requeues); never imports torch",
    )
    pfr.add_argument("--service-dir", action="append", metavar="DIR",
                     help="service root(s) whose traces/ to aggregate")
    pfr.add_argument("--router", metavar="DIR",
                     help="aggregate the router dir plus every fronted host")
    pfr.add_argument("--exemplars", type=int, default=5,
                     help="slowest-job exemplar count (default 5)")
    pfr.add_argument("--json", action="store_true")

    psw = sub.add_parser(
        "sweep",
        help="coverage sweeps over a config lattice (kspec-sweep-lattice/1): "
        "enumerate canonical points, skip statically-vacuous configs, predict "
        "cost from the standing corpus, schedule the portfolio through the "
        "service queue or a router (cheap points batch, expensive points run "
        "solo, repeats are cache hits), and report coverage / violation "
        "frontiers / scaling laws",
    )
    swsub = psw.add_subparsers(dest="sweep_cmd", required=True)
    swp = swsub.add_parser(
        "plan",
        help="enumerate + annotate + predict, dispatch nothing (the vacuity "
        "pass runs the interval analyser on the CPU)",
    )
    swp.add_argument("lattice", help="kspec-sweep-lattice/1 JSON file")
    swp.add_argument("--state-cache-dir", metavar="DIR",
                     help="corpus root for the cost-model fit (default: "
                     "$KSPEC_STATE_CACHE_DIR or <service>/state-cache)")
    swp.add_argument("--service-dir", help=svc_help)
    swp.add_argument("--json", action="store_true")
    swr = swsub.add_parser(
        "run",
        help="run (or crash-resume: only incomplete points re-submit) one sweep "
        "to completion against a live daemon/fleet; the durable kspec-sweep/1 "
        "manifest lands in --sweep-dir",
    )
    swr.add_argument("lattice", help="kspec-sweep-lattice/1 JSON file")
    swr.add_argument("--sweep-dir", required=True,
                     help="sweep state directory (sweep.json manifest; reuse to "
                     "crash-resume, use a fresh one to re-run)")
    swr.add_argument("--service-dir", help=svc_help)
    swr.add_argument("--router", metavar="DIR",
                     help="dispatch through a cross-host router directory instead "
                     "of one service dir")
    swr.add_argument("--tenant", default="sweep")
    swr.add_argument("--max-inflight", type=int, default=64,
                     help="portfolio submit-window width (default 64; clamped "
                     "under the tenant's max_pending cap)")
    swr.add_argument("--solo-threshold", type=int, default=200_000,
                     help="predicted distinct-states at/past which a point submits "
                     "solo instead of joining a batched group (default 200000)")
    swr.add_argument("--timeout", type=float, default=900.0,
                     help="give up after this many seconds without a verdict "
                     "landing (default 900; resume later)")
    swr.add_argument("--state-cache-dir", metavar="DIR")
    swr.add_argument("--json", action="store_true", help="print the final manifest record")
    swrep = swsub.add_parser(
        "report",
        help="render a sweep directory's manifest: coverage, the typed "
        "vacuous-skip rows, the minimal-violating-config frontier per "
        "invariant, scaling-law curves, estimator accuracy",
    )
    swrep.add_argument("sweep_dir")
    swrep.add_argument("--json", action="store_true")
    swb = swsub.add_parser(
        "bisect",
        help="witness the minimal-violating-config frontier: check every "
        "frontier point's lower neighbors from the manifest, and (with "
        "--service-dir/--router) run the neighbors the sweep never ran",
    )
    swb.add_argument("sweep_dir")
    swb.add_argument("--invariant", help="restrict to one invariant")
    swb.add_argument("--service-dir", help=svc_help)
    swb.add_argument("--router", metavar="DIR")
    swb.add_argument("--tenant", default="sweep")
    swb.add_argument("--max-probes", type=int, default=64,
                     help="budget of neighbor runs (default 64)")
    swb.add_argument("--timeout", type=float, default=300.0,
                     help="per-probe verdict timeout (default 300)")
    swb.add_argument("--json", action="store_true")
    if argv is None:
        argv = sys.argv[1:]
    args = p.parse_args(argv)
    if args.cmd in ("submit", "status", "result"):
        # the tenants' side of the service: torch-free (clients never pay
        # the cold start; tests pin it with a poisoned torch)
        return _run_service_client(args)
    if args.cmd == "serve":
        return _serve(args, argv)
    if args.cmd == "serve-fleet":
        return _serve_fleet(args)
    if args.cmd == "route":
        return _run_router(args)
    if args.cmd in ("trace", "top", "fleet-report"):
        return _run_fleet_obs(args)
    if args.cmd == "sweep":
        return _run_sweep(args)
    if args.cmd == "oracle":
        return _oracle(args)
    if args.cmd == "pipelines":
        return _pipelines(args)
    if args.cmd == "analyze":
        return _analyze(args)
    if args.cmd == "verify-checkpoint":
        return _verify_checkpoint(args)
    if args.cmd == "report":
        return _report(args)
    if args.cmd == "faults":
        return _faults(args)
    if args.cmd == "crashcheck":
        return _crashcheck(args)
    if args.cmd == "simfleet":
        return _run_simfleet(args)
    return _simulate(args) if args.cmd == "simulate" else _check(args, argv)


if __name__ == "__main__":
    sys.exit(main())
