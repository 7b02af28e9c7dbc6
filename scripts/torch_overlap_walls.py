#!/usr/bin/env python3
"""Walls of check() on the card with the overlap layer on and off, in turns,
and where the time of the disk tier goes (PyTorch port).

    python3 scripts/torch_overlap_walls.py [--runs N] [--paths P1,P2,...]
        [--out FILE] [--device DEV]

Paths (--paths picks some; default all), each run with the layer on and
with it off (check(overlap=True/False)), `--runs` times a side (default 5)
after one warm-up run a side, the side that goes first swapped every
round:

  kip-default   configs/Kip320.cfg (Kip320 3r, 737,794 states), no knobs
  kip-host      the same on visited_backend="host"
  kip-ckpt      the same with a checkpoint every level
  e3-fused      Kip320 3r E3 (MaxLeaderEpoch 3, 9,985,570 states) on the
                disk tier at mem_budget=16M, fused, one checkpoint after the
                last level
  e3-device     the same on pipeline="device"

A wall is the host clock around check(), ending in synchronize, with a
fresh model each run and a stats file (so that each level records its
overlap accounting); checkpoints and spill files go to
build/overlap_walls/ in the checkout, emptied before each run.  Every run
must give the warm-up's levels.  Per path and side: the median and
quartiles of the walls, staged_chunks_peak, the workers' jobs, and the
levels' overlap_efficiency (median, min, max).

Then one traced run a path with the layer on (a run context): whether a
`checkpoint-write` or `spill-merge` span overlaps a `step` span in wall
time; and, for the e3 paths, one traced run with the layer off: the sum of
each span kind's wall (spill-run-write, spill-merge, checkpoint-write,
step, host-assembly, host-probe, level), the split of the tier's wall.

Prints the card's name and power limit (nvidia-smi), one line a path and
side, and the whole record as JSON on the last line (also written to
--out, default build/overlap_walls.json).  Needs one CUDA card
(--device cpu runs the same on the CPU, for trying the script out);
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
WORK = ROOT / "build" / "overlap_walls"
PATHS = ("kip-default", "kip-host", "kip-ckpt", "e3-fused", "e3-device")
SPAN_KINDS = ("spill-run-write", "spill-merge", "checkpoint-write", "step", "host-assembly",
              "host-probe", "level")


def quartiles(xs) -> dict:
    q = np.percentile(np.asarray(xs, dtype=np.float64), [25, 50, 75])
    return {"q1": float(q[0]), "median": float(q[1]), "q3": float(q[2])}


def spans_of(path) -> list:
    from kafka_specification_tpu_torch.obs.tracer import read_jsonl_tolerant

    return [r for r in read_jsonl_tolerant(path) if r.get("kind") == "span" and r.get("ph") == "E"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--paths", default=",".join(PATHS), help=f"some of {', '.join(PATHS)}")
    ap.add_argument("--out", default=str(ROOT / "build" / "overlap_walls.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    paths = tuple(args.paths.split(","))
    if not paths or set(paths) - set(PATHS):
        ap.error(f"--paths takes some of {', '.join(PATHS)}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_overlap_walls: CUDA is not available", file=sys.stderr)
        return 1
    from kafka_specification_tpu_torch import build_model, check, load_config
    from kafka_specification_tpu_torch.obs import RunContext
    from kafka_specification_tpu_torch.utils.timing import card_line

    card = card_line() if dev.type == "cuda" else "cpu"

    def model(name):
        cfg = load_config("configs/Kip320.cfg")
        if name.startswith("e3"):
            cfg.constants.update({"MaxLeaderEpoch": 3})
        return build_model("Kip320", cfg)

    def knobs(name):
        ck = str(WORK / "ck")
        return {"kip-default": {}, "kip-host": dict(visited_backend="host"),
                "kip-ckpt": dict(checkpoint_dir=ck, checkpoint_every=1),
                "e3-fused": dict(mem_budget="16M", checkpoint_dir=ck, checkpoint_every=32),
                "e3-device": dict(mem_budget="16M", pipeline="device", checkpoint_dir=ck,
                                  checkpoint_every=32)}[name]

    def run(name, on, **extra):
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        kw = dict(knobs(name), **extra)
        if "run" not in kw:
            kw["stats_path"] = str(WORK / "stats.jsonl")
        m = model(name)
        t0 = time.perf_counter()
        res = check(m, device=dev, overlap=on, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    out = {"card": card, "runs": args.runs, "paths": {}}
    print(f"card: {card}", flush=True)
    for name in paths:
        want = {on: run(name, on)[1].levels for on in (True, False)}  # warm-up
        if want[True] != want[False]:
            raise SystemExit(f"{name}: on and off disagree")
        rec = {on: {"walls_s": [], "peak": [], "eff": [], "jobs": None} for on in (True, False)}
        for r in range(args.runs):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                wall, res = run(name, on)
                if res.levels != want[on]:
                    raise SystemExit(f"{name}: a timed run disagrees with the warm-up")
                ov = res.stats["overlap"]
                rec[on]["walls_s"].append(wall)
                rec[on]["peak"].append(ov["staged_chunks_peak"])
                rec[on]["eff"] += [lv["overlap_efficiency"] for lv in res.stats["levels"]]
                rec[on]["jobs"] = {w: ov[w]["jobs"] for w in ("io_worker", "ckpt_worker")
                                   if w in ov}
                rec[on]["sync_ckpt_io_s"] = ov["sync_ckpt_io_s"]
        path_out = {"total": int(sum(want[True]))}
        for on in (True, False):
            side = rec[on]
            eff = side.pop("eff")
            side.update(quartiles(side["walls_s"]), staged_chunks_peak=max(side.pop("peak")),
                        overlap_efficiency={"median": float(np.median(eff)),
                                            "min": float(min(eff)), "max": float(max(eff))})
            path_out["on" if on else "off"] = side
            print(f"{name:12s} {'on ' if on else 'off'} median {side['median']:.4f} s "
                  f"(quartiles {side['q1']:.4f}-{side['q3']:.4f}) over {args.runs} runs; staged "
                  f"peak {side['staged_chunks_peak']}; jobs {side['jobs']}; overlap_efficiency "
                  f"{side['overlap_efficiency']}", flush=True)
        # one traced run with the layer on: did background I/O overlap a step?
        rd = ROOT / "build" / "overlap_walls_runs" / f"{name}-on"
        shutil.rmtree(rd, ignore_errors=True)
        _, res = run(name, True, run=RunContext(str(rd)))
        spans = spans_of(rd / "spans.jsonl")
        steps = [(s["t0"], s["t0"] + s["ms"] / 1e3) for s in spans if s["span"] == "step"]
        io = [(s["span"], s["t0"], s["t0"] + s["ms"] / 1e3) for s in spans
              if s["span"] in ("checkpoint-write", "spill-merge")]
        over = sorted({k for k, a, b in io for s0, s1 in steps if a < s1 and s0 < b})
        path_out["traced_on"] = {"io_spans": len(io), "step_spans": len(steps),
                                 "io_kinds_overlapping_a_step": over}
        print(f"{name:12s} on, traced: {len(io)} checkpoint-write/spill-merge spans, "
              f"{len(steps)} step spans; kinds overlapping a step: {over}", flush=True)
        if name.startswith("e3"):
            # where the tier's time goes with the layer off: span walls by kind
            rd = ROOT / "build" / "overlap_walls_runs" / f"{name}-off"
            shutil.rmtree(rd, ignore_errors=True)
            wall, res = run(name, False, run=RunContext(str(rd)))
            split = {k: round(sum(s["ms"] for s in spans_of(rd / "spans.jsonl")
                                  if s["span"] == k) / 1e3, 4) for k in SPAN_KINDS}
            path_out["split_off"] = {"wall_s": wall, "span_s": split,
                                     "spills": res.stats["spill"]["spills"],
                                     "merges": res.stats["spill"]["merges"]}
            print(f"{name:12s} off, traced: wall {wall:.4f} s; span seconds {split}", flush=True)
        out["paths"][name] = path_out
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "overlap_walls_runs", ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
