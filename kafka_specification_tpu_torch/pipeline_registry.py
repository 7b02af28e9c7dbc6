"""Level-pipeline names: the port's copy of
``kafka_specification_tpu/pipeline_registry.py``'s name set and
``resolve_pipeline`` (explicit name > ``$KSPEC_PIPELINE`` > "fused").

The JAX package names three pipelines.  "legacy" and "fused" are ported:
they differ there only in how XLA programs are cut, and give the same
result, so one implementation serves both here (``engine/pipeline.py``).
"device" (the device-resident level program) is not ported and raises
rather than quietly running as another pipeline.
"""

from __future__ import annotations

import os

PIPELINE_ENV = "KSPEC_PIPELINE"
PIPELINES = ("device", "fused", "legacy")
PORTED = ("fused", "legacy")
DEFAULT_PIPELINE = "fused"


def resolve_pipeline(name=None) -> str:
    """The pipeline a check runs: `name`, else $KSPEC_PIPELINE, else the
    default.  Unknown and unported names raise ValueError."""
    n = name or os.environ.get(PIPELINE_ENV) or DEFAULT_PIPELINE
    if n not in PIPELINES:
        raise ValueError(f"unknown pipeline {n!r} (expected one of {PIPELINES})")
    if n not in PORTED:
        raise ValueError(
            f"pipeline {n!r} is not ported to PyTorch yet (ported: {', '.join(PORTED)})"
        )
    return n
