#!/usr/bin/env python3
"""The construct ladder on the card: the six rungs of kernel K4 (PyTorch port).

    python3 scripts/cuda_kernel_ladder.py [--n 256] [--device cuda] [--out PATH]

Counterpart of scripts/tpu_mosaic_ladder.py.  Runs arange(n) u32 through
every rung (ops/cuda_ladder.py::run_ladder): each kernel is built, launched
once, compared with its plain version bit for bit, and timed with CUDA
events.  Prints one JSON line per rung as soon as that rung has run, with
the platform and the card's name, and writes all records to PATH only when
--out is given.  Exits 0 when every rung built, launched and equalled its
plain version, and 3 otherwise; a rung that raises ends the ladder, since a
CUDA fault leaves the context unusable.  `--device cpu` runs the plain
versions only.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kafka_specification_tpu_torch.ops.cuda_ladder import run_ladder  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="elements (default 256, the TPU script's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the records here as JSON")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("cuda_kernel_ladder: CUDA is not available; nothing was run", file=sys.stderr)
        return 3
    head = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n": args.n,
    }
    banked = dict(head, rungs={})

    def emit(rec):
        print(json.dumps(head | rec), flush=True)
        if args.out is not None:
            banked["rungs"][rec["rung"]] = rec
            tmp = f"{args.out}.tmp"
            with open(tmp, "w") as f:
                json.dump(banked, f, indent=1)
            os.replace(tmp, args.out)

    records = run_ladder(dev, args.n, emit=emit)
    return 0 if all(r["ok"] for r in records) else 3


if __name__ == "__main__":
    sys.exit(main())
