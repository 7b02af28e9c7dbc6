"""Level-pipeline names: the port's copy of what
``kafka_specification_tpu/pipeline_registry.py`` decides for one card —
the name set, the one (pipeline, backend) cell that is not served natively
and the reason it stamps into ``stats["device"]["fallback"]`` (letter for
letter the JAX package's), and ``resolve_pipeline`` (explicit name >
``$KSPEC_PIPELINE`` > "fused").

"legacy" and "fused" differ in the JAX package only in how XLA programs
are cut and give the same result, so one implementation serves both here
(``engine/pipeline.py::run_chunk``).  "device" is the device-resident
level pipeline (``engine/pipeline.py::DevicePipeline``); on the
``device-hash`` backend it degrades to "fused".
"""

from __future__ import annotations

import os

PIPELINE_ENV = "KSPEC_PIPELINE"
PIPELINES = ("device", "fused", "legacy")
DEFAULT_PIPELINE = "fused"

# the JAX package's support-matrix detail of ("device", "device-hash"),
# prefixed as its backend_fallback_reason does
DEVICE_HASH_REASON = (
    "visited backend 'device-hash': the open-addressing HBM table mutates in "
    "place per probe (no read-only in-loop form), so a whole-level program "
    "has no exact replay on overflow — runs the fused per-chunk ladder "
    "instead (identical results)"
)


def backend_fallback_reason(name: str, backend: str):
    """None when pipeline `name` serves visited `backend` natively, else
    the reason it degrades (the JAX package's text)."""
    resolve_pipeline(name)
    return DEVICE_HASH_REASON if (name, backend) == ("device", "device-hash") else None


def resolve_pipeline(name=None) -> str:
    """The pipeline a check runs: `name`, else $KSPEC_PIPELINE, else the
    default.  Unknown names raise ValueError."""
    n = name or os.environ.get(PIPELINE_ENV) or DEFAULT_PIPELINE
    if n not in PIPELINES:
        raise ValueError(f"unknown pipeline {n!r} (expected one of {PIPELINES})")
    return n
