#!/usr/bin/env python3
"""Walls of the harness phase's host work, on two checkouts in turns
(PyTorch port).

    python3 scripts/torch_harness_walls.py TREE [TREE ...] [--runs N]
        [--device DEV] [--out FILE]

Each TREE is the root of a checkout (this one, or a `git archive` of
another commit).  Per round, every tree in turn, the order swapped every
round, each leg in a fresh process whose import path is that tree:

  crashcheck       `python -m kafka_specification_tpu_torch.cli crashcheck --json`
  crashcheck-ckpt  the same with `--protocol ckpt`
  ckpt-legs        chip_smoke.py's harness part (c) without the recorder:
                   Kip320 3r with a checkpoint every level cut at depth 11,
                   then at 12, then a copy of the directory resumed to the
                   end (three walls: cut, leg, resume)

A wall is the host clock around the child process (crashcheck) or around
check() inside it (ckpt-legs).  Prints one line a tree and leg (the walls
of every round, and their median) and the whole record as JSON on the
last line (also written to --out, default build/harness_walls.json in
this checkout).  `--device cpu` runs on the CPU; the default is the card.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CKPT_LEGS = r"""
import json, os, shutil, sys, time
import torch
from kafka_specification_tpu_torch import build_model, check, load_config
dev, work = sys.argv[1], sys.argv[2]
cfg = load_config("configs/Kip320.cfg")
ck = os.path.join(work, "ck")
walls = {}
for leg, depth in (("cut", 11), ("leg", 12)):
    t0 = time.perf_counter()
    check(build_model("Kip320", cfg), device=dev, checkpoint_dir=ck, max_depth=depth)
    walls[leg] = time.perf_counter() - t0
shutil.copytree(ck, os.path.join(work, "copy"))
t0 = time.perf_counter()
res = check(build_model("Kip320", cfg), device=dev, checkpoint_dir=os.path.join(work, "copy"))
if dev != "cpu":
    torch.cuda.synchronize()
walls["resume"] = time.perf_counter() - t0
assert res.ok and res.total == 737794 and res.diameter == 25, (res.total, res.diameter)
print(json.dumps(walls))
"""


def _child(tree: str, argv: list) -> tuple:
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable] + argv, cwd=tree, env=env,
                       capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise SystemExit(f"{tree}: {argv[:3]} exit {p.returncode}\n{p.stderr[-2000:]}")
    return wall, p.stdout


def _round(tree: str, device: str) -> dict:
    out = {}
    cli = ["-m", "kafka_specification_tpu_torch.cli", "crashcheck", "--json"]
    out["crashcheck"], _ = _child(tree, cli)
    out["crashcheck-ckpt"], _ = _child(tree, cli + ["--protocol", "ckpt"])
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        _, text = _child(tree, ["-c", CKPT_LEGS, device, work])
    for leg, wall in json.loads(text.strip().splitlines()[-1]).items():
        out[f"ckpt-legs {leg}"] = wall
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "harness_walls.json"))
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    trees = [os.path.abspath(t) for t in args.trees]
    walls = {t: {} for t in trees}
    for r in range(args.runs):
        for t in (trees if r % 2 == 0 else trees[::-1]):
            for leg, w in _round(t, args.device).items():
                walls[t].setdefault(leg, []).append(w)
    rec = {"device": args.device, "runs": args.runs, "walls": walls,
           "median": {t: {leg: statistics.median(ws) for leg, ws in legs.items()}
                      for t, legs in walls.items()}}
    for t, legs in walls.items():
        for leg, ws in legs.items():
            print(f"{t} {leg}: {[round(w, 3) for w in ws]} median "
                  f"{statistics.median(ws):.3f} s")
    with open(args.out, "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
