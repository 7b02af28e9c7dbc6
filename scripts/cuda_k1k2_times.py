#!/usr/bin/env python3
"""Own and route times of kernels K1 and K2 on the card, beside their bounds.

    python3 scripts/cuda_k1k2_times.py [--root DIR] [--repeat N] [--label L]

At the shapes of check() of configs/Kip320.cfg, per kernel: own time,
route time (median, min and max of 50 calls), host µs a launch, bound and
plain time, as utils/kernel_times.py defines them.  --root DIR times the
package of another checkout that has that module (a parent commit unpacked
with `git archive`, say), so that two versions are compared in one call on
one card.  Prints one JSON line per repeat, then the card's name and power
limit.  Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is timed")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuda_k1k2_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from kafka_specification_tpu_torch.utils import kernel_times as kt
    from kafka_specification_tpu_torch.utils.timing import card_line

    dev = torch.device("cuda")
    card = card_line()
    lanes, valid = kt.k1_inputs(dev)
    table0, q, _ = kt.k2_fixture(dev)
    for r in range(args.repeat):
        rec = {"label": args.label or args.root, "repeat": r, "card": card,
               "K1": kt.k1_times(lanes, valid), "K2": kt.k2_times(table0, q)}
        print(json.dumps(rec), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
