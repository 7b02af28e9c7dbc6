#!/usr/bin/env python3
"""Own, route and host times of kernels K1, K2 and K4 on the card, beside
their bounds, and the split of one call's host time into the launch
route's parts.

    python3 scripts/cuda_k1k2_times.py [--root DIR] [--repeat N] [--label L]

Per repeat, as utils/kernel_times.py defines them: K1 and K2 at the shapes
of check() of configs/Kip320.cfg (own time, route time: median, min and
max of 50 calls, host µs a launch, bound, plain time); the host split of a
rung, K1 and K2 call and of torch.add beside them (host_split); and every
K4 rung at n = 256 and 2^24 (own, route, host µs, bound, plain and library
time; scripts/cuda_kernel_ladder.py --n runs the ladder at any other n).

--root DIR times the package of another checkout (a parent commit
unpacked with `git archive`, say) with this checkout's timing code, so
that two versions are compared in one call on one card: that package is
loaded under another name beside this one.  Prints one JSON line per
repeat, then the card's name and power limit.  Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import types
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from kafka_specification_tpu_torch.utils import kernel_times as kt  # noqa: E402
from kafka_specification_tpu_torch.utils.timing import card_line  # noqa: E402

PKG = "kafka_specification_tpu_torch"
MODULES = ("build", "cuda_fingerprint", "cuda_hashset", "cuda_ladder", "hashset")


def load_ops(root: Path) -> types.SimpleNamespace:
    """The kernel modules of the package under `root`: this checkout's, or
    another's loaded under the name `kspec_torch_at_root`."""
    if root.resolve() == HERE:
        return kt.this_ops()
    alias = "kspec_torch_at_root"
    spec = importlib.util.spec_from_file_location(
        alias, root / PKG / "__init__.py", submodule_search_locations=[str(root / PKG)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return types.SimpleNamespace(
        **{m: importlib.import_module(f"{alias}.ops.{m}") for m in MODULES})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuda_k1k2_times: CUDA is not available", file=sys.stderr)
        return 1
    ops = load_ops(Path(args.root))
    dev = torch.device("cuda")
    card = card_line()
    lanes, valid = kt.k1_inputs(dev)
    table0, q, _ = kt.k2_fixture(dev, hashset=ops.hashset)
    for r in range(args.repeat):
        rec = {"label": args.label or args.root, "repeat": r, "card": card,
               "K1": kt.k1_times(lanes, valid, ops), "K2": kt.k2_times(table0, q, ops),
               "host_split": kt.host_split(ops),
               "K4": {n: kt.ladder_times(n, dev, ops)
                      for n in (kt.LADDER_N, kt.LADDER_LARGE_N)}}
        print(json.dumps(rec), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
