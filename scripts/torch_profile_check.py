#!/usr/bin/env python3
"""Where the time of one check() goes on the card (PyTorch port).

    python3 scripts/torch_profile_check.py [configs/Kip320.cfg] [--module NAME]
        [--runs N] [--root DIR] [--set NAME=VALUE ...]
        [--visited-backend device|device-hash] [--pipeline fused|device] [--max-depth N]
        [--chunk-size N] [--min-bucket N]
        [--emitted [--reference DIR]]
        | [--simulate [--walks W] [--depth D] [--seed S]]

Runs check() of the .cfg once to build the kernels and warm up, then `--runs`
times (default 3) unprofiled for the wall time (host clock, ending in
synchronize), then once more under torch.profiler (CPU and CUDA
activities), and prints: the card's name and power limit (nvidia-smi), the
unprofiled walls, the profiled run's wall time, the summed device time of
all kernels, the device's busy and idle share of the wall time (one
stream, so kernels do not overlap), the number of operations the run put on
the card (kernels, fills and copies), the port's two CUDA kernels' device
time and launches, the device time of each stage of the level loop (the
profiled run only: each stage function is wrapped in a
torch.profiler.record_function range, whose device time sums the kernels
launched inside it by PyTorch operations; K1's and K2's launches go
through ctypes and count only in their own lines), and the kernels with
the most device time.  The last
line is the same as JSON.

check() runs with its defaults (the sorted `device` visited set, the fused
pipeline, compact_shift 2); --visited-backend device-hash runs the path the
port had before the sorted set: the hash table, pipeline "legacy",
compact_shift 0; --pipeline device runs the device-resident level
pipeline (with the defaults' sorted set), whose chunks show as the stage
device_chunk and whose one host read a level as device_read.  --root DIR
profiles the package of another checkout (the
parent commit unpacked with `git archive`, say), whose check() takes those
knobs for --visited-backend device-hash.  --set overrides a constant of the
.cfg (a comma-separated value is a set of model values: `--set
Replicas=b1,b2`), --max-depth cuts the check (a profile of a run of tens
of millions of operations would not fit in memory), --chunk-size and
--min-bucket set check()'s knobs of those names (the 5-broker bounded
run's: `configs/Kip320Stretch.cfg --module Kip320 --set Partitions=1
--chunk-size 131072 --min-bucket 8192 --max-depth 15`), and --simulate
profiles
`simulate` (engine/simulate.py) of the model in place of check(): it
takes --walks, --depth and --seed (default 100, 100, 0), which check()
does not, and refuses check()'s --visited-backend and --max-depth.
--emitted profiles the model emitted from the TLA+ text of --reference
(default $KSPEC_REFERENCE; `tests/torch_tla` holds IdSequence and
FiniteReplicatedLog) in place of the hand-written one.  Needs one CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

# device-side kernel names of the port's K1 and K2 sources
OWN_KERNELS = {
    "fingerprint": ("fingerprint_kernel",),
    "hash_probe_insert": ("probe_insert_kernel",),
}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# stage -> (module, attribute, ...) of the function wrapped in a profiler
# range: the first attribute the package has (older packages lack some)
STAGES = {
    "invariants": ("engine.pipeline", "invariant_flags", "invariant_stage"),
    "expand": ("engine.pipeline", "expand_stage"),
    "squeeze": ("engine.pipeline", "squeeze_stage"),
    "pack": ("ops.packing", "StateSpec.pack"),
    "fingerprint": ("engine.pipeline", "fp_stage"),
    "fingerprint_masked": ("engine.pipeline", "fp_masked"),
    "dedup_sorted": ("engine.bfs", "sorted_dedup_stage"),
    "dedup_hash": ("engine.bfs", "_HashVisited.insert"),
    "rank": ("ops.dedup", "rank_sorted"),
    "merge": ("ops.dedup", "merge_ranked"),
    "device_chunk": ("engine.pipeline", "DevicePipeline._chunk"),
    "device_read": ("engine.pipeline", "DevicePipeline.read_level"),
}


def _wrap_stages(pkg):
    """Wrap each stage function found in the package in a record_function
    range named stage:<name>; returns the names wrapped."""
    import functools
    import importlib

    wrapped = []
    for stage, (mod_name, *attrs) in STAGES.items():
        for attr in attrs:
            try:
                owner = importlib.import_module(f"{pkg}.{mod_name}")
                *path, name = attr.split(".")
                for part in path:
                    owner = getattr(owner, part)
                fn = getattr(owner, name)
                break
            except (ImportError, AttributeError):
                continue
        else:
            continue  # an older package without this stage

        def ranged(*a, _fn=fn, _label=f"stage:{stage}", **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        setattr(owner, name, functools.wraps(fn)(ranged))
        wrapped.append(stage)
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default="configs/Kip320.cfg")
    ap.add_argument("--module", default=None, help="TLA+ module (default: the file stem)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--runs", type=int, default=3, help="unprofiled runs timed for the wall")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is profiled")
    ap.add_argument("--visited-backend", choices=["device", "device-hash"], default=None,
                    help="device (default): check() with its defaults; device-hash: the hash "
                         "table, pipeline legacy, compact_shift 0")
    ap.add_argument("--pipeline", choices=["fused", "device"], default=None,
                    help="with the default backend: 'device' runs the device-resident "
                         "level pipeline")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="override a .cfg constant (a,b,c: a set of model values)")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="check()'s chunk_size (default: check()'s, 32768)")
    ap.add_argument("--min-bucket", type=int, default=None,
                    help="check()'s min_bucket (default: check()'s, 256)")
    ap.add_argument("--simulate", action="store_true",
                    help="profile simulate(--walks, --depth, --seed) in place of check()")
    ap.add_argument("--walks", type=int, default=None, help="with --simulate (default 100)")
    ap.add_argument("--depth", type=int, default=None, help="with --simulate (default 100)")
    ap.add_argument("--seed", type=int, default=None, help="with --simulate (default 0)")
    ap.add_argument("--emitted", action="store_true",
                    help="the model emitted from the reference's TLA+ text")
    ap.add_argument("--reference", default=None,
                    help="with --emitted: the TLA+ directory (default $KSPEC_REFERENCE)")
    args = ap.parse_args()
    if args.simulate and (args.visited_backend is not None or args.max_depth is not None
                          or args.pipeline is not None or args.chunk_size is not None
                          or args.min_bucket is not None):
        ap.error("--simulate takes no --visited-backend, --pipeline, --max-depth, "
                 "--chunk-size or --min-bucket")
    if args.pipeline == "device" and args.visited_backend == "device-hash":
        ap.error("--pipeline device runs on the default backend")
    if args.reference is not None and not args.emitted:
        ap.error("--reference needs --emitted")
    if not args.simulate and (args.walks, args.depth, args.seed) != (None, None, None):
        ap.error("--walks, --depth and --seed need --simulate")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from kafka_specification_tpu_torch import build_model as _build_model
    from kafka_specification_tpu_torch import check as _check
    from kafka_specification_tpu_torch import load_config
    from kafka_specification_tpu_torch.utils.timing import card_line

    if not torch.cuda.is_available():
        print("torch_profile_check: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    module = args.module or Path(args.cfg).stem
    cfg = load_config(args.cfg)

    def build_model(module, cfg):
        if args.emitted:
            return _build_model(module, cfg, emitted=True, reference=args.reference)
        return _build_model(module, cfg)  # a --root checkout may predate emitted=

    for item in args.set:
        name, _, value = item.partition("=")
        cfg.constants[name] = (value.split(",") if "," in value else
                               int(value) if value.lstrip("-").isdigit() else value)

    if args.simulate:
        from kafka_specification_tpu_torch.engine.simulate import simulate

        walks, depth, seed = (100 if args.walks is None else args.walks,
                              100 if args.depth is None else args.depth, args.seed or 0)

        def run(model):
            return simulate(model, num_walks=walks, max_depth=depth, seed=seed)
    else:
        knobs = ({} if args.visited_backend in (None, "device") else
                 dict(visited_backend="device-hash", pipeline="legacy", compact_shift=0))
        if args.pipeline is not None:
            knobs["pipeline"] = args.pipeline
        if args.chunk_size is not None:
            knobs["chunk_size"] = args.chunk_size
        if args.min_bucket is not None:
            knobs["min_bucket"] = args.min_bucket

        def run(model):
            return _check(model, max_depth=args.max_depth, **knobs)
    warm = run(build_model(module, cfg))
    walls = []
    for _ in range(args.runs):
        model = build_model(module, cfg)
        t0 = time.perf_counter()
        res = run(model)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if (res.levels, res.total) != (warm.levels, warm.total):
            raise SystemExit("a timed run disagrees with the warm-up run")
    wrapped = _wrap_stages("kafka_specification_tpu_torch")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    model = build_model(module, cfg)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if (res.levels, res.total) != (warm.levels, warm.total):
        raise SystemExit("the profiled run disagrees with the warm-up run")

    # kernels only: an operator's row repeats the device time of its kernels,
    # and a stage's range shows on the card's timeline too, as a span
    by_name = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("stage:")):
            by_name[evt.key] = (us, evt.count)
    # a stage's device time: the kernels launched inside its host-side range
    stages = {}
    for evt in prof.events():
        if evt.name.startswith("stage:") and evt.device_type == torch.autograd.DeviceType.CPU:
            st = stages.setdefault(evt.name[6:], {"device_ms": 0.0, "calls": 0})
            st["device_ms"] += evt.device_time_total / 1e3
            st["calls"] += 1
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    device_ops = sum(n for _, n in by_name.values())
    own = {}
    for kname, subs in OWN_KERNELS.items():
        hits = [(k, v) for k, v in by_name.items() if any(s in k for s in subs)]
        own[kname] = {
            "device_ms": sum(v[0] for _, v in hits) / 1e3,
            "launches": max((v[1] for _, v in hits), default=0),
        }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]

    print(f"card: {card}")
    print(f"{res.model}: ok={res.ok} total={res.total} diameter={res.diameter}; "
          f"{res.stats.get('visited_backend', res.stats.get('mode'))}, "
          f"{res.stats.get('pipeline')}")
    print("unprofiled walls " + ", ".join(f"{w:.3f}" for w in walls) + " s")
    print(f"wall {wall:.3f} s (host clock, ends in synchronize); "
          f"{res.total / wall:.0f} states/s")
    print(f"device kernels {device_s:.3f} s: busy {device_s / wall:.1%}, "
          f"idle {1 - device_s / wall:.1%}; {device_ops} operations on the card")
    for kname, v in own.items():
        print(f"  {kname}: {v['device_ms']:.3f} ms device over {v['launches']} launches")
    print("device time by stage (ranges nest: squeeze holds pack, dedup_sorted rank and merge):")
    for stage in wrapped:
        v = stages.get(stage, {"device_ms": 0.0, "calls": 0})
        print(f"  {stage}: {v['device_ms']:.3f} ms over {v['calls']} calls")
    print("top device time:")
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.3f} ms  {n:6d}x  {name[:90]}")
    print(json.dumps({
        "card": card,
        "model": res.model,
        "total": res.total,
        "walls_s": walls,
        "wall_s": wall,
        "device_ops": device_ops,
        "device_s": device_s,
        "busy_share": device_s / wall,
        "visited_backend": res.stats.get("visited_backend"),
        "mode": res.stats.get("mode", "check"),
        "max_depth": args.max_depth,
        "chunk_size": args.chunk_size,
        "min_bucket": args.min_bucket,
        "set": args.set,
        "pipeline": res.stats.get("pipeline"),
        "own_kernels": own,
        "stages": stages,
        "top": [{"name": n, "device_ms": us / 1e3, "count": c} for n, (us, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
