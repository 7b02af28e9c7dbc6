#!/usr/bin/env python3
"""Unprofiled walls of check() on the card, several ways in turns, in one
process (PyTorch port).

    python3 scripts/torch_slice_walls.py [configs/Kip320.cfg] [--module NAME]
        [--runs N] [--resume-at DEPTH] [--ways W1,W2,...] [--set NAME=VALUE ...]
        [--shards D] [--root DIR]

Ways to run the same check (--ways picks some; default all), each timed
`--runs` times (default 10) after one warm-up run of each, the order
rotated every round so that no way always runs first:

  default      check() with its defaults (the sorted `device` set, fused)
  no-chain     the same with KSPEC_INTEGRITY=0: no level digest chain
  host         visited_backend="host": the native C++ fingerprint set
  checkpoint   the defaults with a checkpoint every level, uninterrupted
  resume       the defaults with a checkpoint every level, cut at
               --resume-at (default 12), then resumed by a fresh check();
               the wall is the two legs together
  device       pipeline="device": the device-resident level pipeline
  device-host  pipeline="device" on visited_backend="host"

--shards D runs every way through the sharded engine instead,
check_sharded() at D logical shards on cuda:0 (`default` is then its
per-chunk path, `device` its device-resident level).

--set overrides a .cfg constant (a comma-separated value is a set of model
values: `--set Replicas=b1,b2`), as in scripts/torch_profile_check.py.
--root DIR times the package of another checkout (the parent commit
unpacked with `git archive`, say; its check() must take the knobs of the
ways asked for), so that two commits are compared on one card by running
the script in turns, once with --root and once without.

A wall is the host clock around check(), ending in synchronize, with a
fresh model each run; checkpoints go to build/slice_walls/ in the checkout,
emptied before each run.  Every run must give the warm-up's levels.
Prints the card's name and power limit (nvidia-smi), one line a way with
the median and range, and the same as JSON on the last line.  Needs one
CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "slice_walls"
WAYS = ("default", "no-chain", "host", "checkpoint", "resume", "device", "device-host")
KNOBS = {"host": dict(visited_backend="host"), "device": dict(pipeline="device"),
         "device-host": dict(pipeline="device", visited_backend="host")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default="configs/Kip320.cfg")
    ap.add_argument("--module", default=None, help="TLA+ module (default: the file stem)")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--resume-at", type=int, default=12)
    ap.add_argument("--ways", default=",".join(WAYS),
                    help=f"comma-separated, of {', '.join(WAYS)}")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="override a .cfg constant (a,b,c: a set of model values)")
    ap.add_argument("--shards", type=int, default=0,
                    help="D > 0: check_sharded() at D logical shards on cuda:0")
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package is timed")
    args = ap.parse_args()
    ways = tuple(args.ways.split(","))
    if not ways or set(ways) - set(WAYS):
        ap.error(f"--ways takes some of {', '.join(WAYS)}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from kafka_specification_tpu_torch import build_model, check, load_config
    from kafka_specification_tpu_torch.utils.timing import card_line

    if args.shards > 0:
        from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded

        def check(model, **knobs):  # noqa: F811 -- the sharded engine, same knobs
            return check_sharded(model, mesh=ShardMesh(args.shards, "cuda"), **knobs)

    if not torch.cuda.is_available():
        print("torch_slice_walls: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    module = args.module or Path(args.cfg).stem
    cfg = load_config(args.cfg)
    for item in args.set:
        name, _, value = item.partition("=")
        cfg.constants[name] = (value.split(",") if "," in value else
                               int(value) if value.lstrip("-").isdigit() else value)

    def run(way):
        """One check() the given way -> (wall seconds, levels)."""
        shutil.rmtree(WORK, ignore_errors=True)
        knobs = dict(KNOBS.get(way, {}))
        if way in ("checkpoint", "resume"):
            knobs["checkpoint_dir"] = str(WORK)
        legs = [dict(max_depth=args.resume_at), {}] if way == "resume" else [{}]
        prev = os.environ.get("KSPEC_INTEGRITY")
        os.environ["KSPEC_INTEGRITY"] = "0" if way == "no-chain" else "1"
        try:
            t0 = time.perf_counter()
            for leg in legs:
                res = check(build_model(module, cfg), **knobs, **leg)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, res.levels
        finally:
            if prev is None:
                del os.environ["KSPEC_INTEGRITY"]
            else:
                os.environ["KSPEC_INTEGRITY"] = prev

    want = {way: run(way)[1] for way in ways}  # warm-up: build, load, first calls
    first = want[ways[0]]
    if any(levels != first for levels in want.values()):
        raise SystemExit(f"the ways disagree: {want}")
    walls = {way: [] for way in ways}
    for r in range(args.runs):
        for i in range(len(ways)):
            way = ways[(r + i) % len(ways)]
            wall, levels = run(way)
            if levels != want[way]:
                raise SystemExit(f"{way}: a timed run disagrees with the warm-up")
            walls[way].append(wall)
    shutil.rmtree(WORK, ignore_errors=True)

    out = {"card": card, "root": args.root, "cfg": args.cfg, "set": args.set, "runs": args.runs,
           "resume_at": args.resume_at, "shards": args.shards, "total": sum(first),
           "ways": {}}
    print(f"card: {card}")
    for way in ways:
        w = walls[way]
        rec = {"median_s": statistics.median(w), "min_s": min(w), "max_s": max(w), "walls_s": w}
        out["ways"][way] = rec
        print(f"{way:10s} median {rec['median_s']:.4f} s (min {rec['min_s']:.4f}, "
              f"max {rec['max_s']:.4f}) over {len(w)} runs")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
