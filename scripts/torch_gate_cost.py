#!/usr/bin/env python3
"""Host seconds of the encoding gate and of the device pipeline's hull
check, per model (PyTorch port).

    python3 scripts/torch_gate_cost.py [CFG[:MODULE] ...]

For each .cfg (default: configs/Kip320.cfg and configs/Kip320Stretch.cfg
as Kip320), in one fresh process, on the host's clock:

  gate_cold     analysis.require_encoding_sound on a newly built model:
                the interval pass over every action kernel (what the
                first check() or build_model of a process pays)
  gate_memo     the same on a second model built from the same config:
                the structural memo key and a set lookup (what every
                later check() pays)
  hulls         engine/pipeline.py::device_hull_fallback on the first
                model after its gate (pipeline="device" pays it once a
                check; the interval runs are shared with the gate)
  hulls_memo    the same on the second model

The models are built with KSPEC_ANALYZE=0 so that building runs no gate.
Prints one line a model and the same as JSON on the last line.  Needs no
card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ("configs/Kip320.cfg", "configs/Kip320Stretch.cfg:Kip320")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from kafka_specification_tpu_torch import analysis, build_model, load_config
    from kafka_specification_tpu_torch.engine.pipeline import device_hull_fallback

    out = {}
    for item in sys.argv[1:] or DEFAULT:
        path, _, module = item.partition(":")
        module = module or Path(path).stem
        cfg = load_config(str(ROOT / path))
        os.environ["KSPEC_ANALYZE"] = "0"
        first, second = build_model(module, cfg), build_model(module, cfg)
        del os.environ["KSPEC_ANALYZE"]
        rec = {}
        for name, fn, model in (("gate_cold", analysis.require_encoding_sound, first),
                                ("gate_memo", analysis.require_encoding_sound, second),
                                ("hulls", device_hull_fallback, first),
                                ("hulls_memo", device_hull_fallback, second)):
            t0 = time.perf_counter()
            got = fn(model)
            rec[name] = time.perf_counter() - t0
            if got is not None:
                raise SystemExit(f"{item}: {name} gave {got!r}")
        out[item] = rec
        print(f"{item} ({first.name}, {len(first.actions)} actions, {len(first.spec.fields)} "
              f"fields): " + ", ".join(f"{k} {v:.6f} s" for k, v in rec.items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
