"""Level-pipeline registry: the one source of the pipeline names that the
CLI's parser, ``cli pipelines`` and ``resolve_pipeline`` validate against,
and of each name's support matrix.

The port's copy of ``kafka_specification_tpu/pipeline_registry.py``.  The
names, their order, the default, each entry's ``fallback``, every backend
cell's ``supported`` flag and the detail of the one backend cell that is
not served natively, ``("device", "device-hash")``, are the JAX package's:
that detail is the reason the engine stamps into
``stats["device"]["fallback"]``, letter for letter; so is the detail of
the sharded engine's "device" cell.  What the other entries say they run
(``launches``, ``description``, the cells' details) is the port's: CUDA
launches and host reads on one card, not XLA programs.

"legacy" and "fused" differ in the JAX package only in how XLA programs
are cut and give the same result, so one implementation serves both here
(``engine/pipeline.py::run_chunk``).  "device" is the device-resident
level pipeline (``engine/pipeline.py::DevicePipeline``); on the
``device-hash`` backend it degrades to "fused".  The ``sharded`` engine
cells carry the JAX package's flags: "legacy" runs the sharded per-chunk
step (``parallel/sharded.py``), "fused" names the same step (its overlap
legs, the disk tier and the governor included), and "device" runs the
device-resident sharded level (``parallel/sharded.py::
ShardedDeviceLevel``), degrading to the per-chunk step as in the JAX
package.
"""

from __future__ import annotations

import os

PIPELINE_ENV = "KSPEC_PIPELINE"

#: the engines a pipeline selection can land on: keys of every entry's
#: per-engine support matrix (the JAX package's two)
ENGINES = ("single-device", "sharded")

#: the visited backends a pipeline can be asked to serve: keys of every
#: entry's per-backend support matrix
BACKENDS = ("device", "device-hash", "host")

#: name -> registry entry; insertion order is the display order and the
#: degradation ladder reads right to left (device -> fused -> legacy)
PIPELINE_REGISTRY = {
    "device": {
        "launches": "one K1 launch per chunk, one host read per LEVEL",
        "description": (
            "device-resident level pipeline: every gated chunk of a BFS "
            "level is queued on the card at fixed shapes with no host read "
            "between chunks — the action kernels on the whole chunk, a "
            "per-action compaction into fixed-width segments, the pack, "
            "fingerprints (K1), novelty against a level-new sorted set on "
            "the card, the winners' appends, verdicts and (device backend) "
            "the level's digest fold.  The host reads the level's outcome "
            "once (twice when an overflow re-dispatches the level at its "
            "measured widths).  Sorted-set backend: the visited set is "
            "merged once per level.  Host backend: the visited probe is "
            "deferred to one batched host insert per level.  Requires the "
            "analyzer's proven per-field value hulls; anything else "
            "degrades to 'fused'"
        ),
        "fallback": "fused",
        "backends": {
            "device": {
                "supported": True,
                "detail": (
                    "novelty against the read-only visited set and the "
                    "level-new set on the card, ONE rank merge into the "
                    "visited set per level, the digest folded on the card"
                ),
            },
            "host": {
                "supported": True,
                "detail": (
                    "deferred once-per-level batched host dedup: "
                    "intra-level novelty on the card's level-new set, the "
                    "level's novel candidates inserted into the native host "
                    "FpSet (or the disk tier's bloom-gated sorted runs) in "
                    "ONE batch per level, in candidate order, so results "
                    "equal 'fused'"
                ),
            },
            "device-hash": {
                "supported": False,
                "detail": (
                    "the open-addressing HBM table mutates in place per "
                    "probe (no read-only in-loop form), so a whole-"
                    "level program has no exact replay on overflow — "
                    "runs the fused per-chunk ladder instead (identical "
                    "results)"
                ),
            },
        },
        "engines": {
            "single-device": {
                "supported": True,
                "detail": (
                    "every gated chunk of a level queued on the card, one "
                    "host read a level, on the device and host/disk-tier "
                    "visited backends; degrades to 'fused' per chunk on the "
                    "device-hash backend, for a sub-gate tail chunk, or on "
                    "unproven field hulls"
                ),
            },
            "sharded": {
                "supported": True,
                "detail": (
                    "per-shard one-dispatch level programs: each shard "
                    "runs a whole level's gated chunks — expansion, the "
                    "per-chunk all_to_all/all_gather exchange (+ the "
                    "compression codec), dual-probe dedup against a "
                    "read-only visited shard + a per-shard level-new "
                    "set, in-jit digest folds — inside ONE dispatched "
                    "program: O(1) collective-bearing launches per "
                    "level per shard, the O(capacity) visited merge "
                    "(device backend) or ONE batched per-shard host "
                    "FpSet probe (host/disk-tier backends) once per "
                    "level per shard.  Requires proven field hulls and "
                    "a sorted-dedup backend; device-hash degrades to "
                    "the per-chunk sharded step "
                    "(sharded-device -> per-chunk -> legacy ladder)"
                ),
            },
        },
    },
    "fused": {
        "launches": "one K1 launch per chunk (and one K2 on device-hash)",
        "description": (
            "the per-chunk path (the default): every action kernel on every "
            "(state, choice) cell of the chunk in one batched call, the "
            "enabled cells squeezed at their exact counts in candidate "
            "order, fingerprints (K1), then dedup by the visited backend; "
            "the chunk's host copies are staged so its commit overlaps the "
            "next chunk's kernels"
        ),
        "fallback": "legacy",
        "backends": {
            "device": {
                "supported": True,
                "detail": "sort, probe and rank merge into the sorted set on the card per chunk",
            },
            "host": {
                "supported": True,
                "detail": (
                    "fingerprints on the card, every dedup on the host "
                    "FpSet or the disk tier (one host probe per chunk — "
                    "the per-chunk reads the 'device' pipeline's deferred "
                    "probe collapses)"
                ),
            },
            "device-hash": {
                "supported": True,
                "detail": "per-chunk insert-or-find on the open-addressing table on the card (K2)",
            },
        },
        "engines": {
            "single-device": {
                "supported": True,
                "detail": "the default single-device path",
            },
            "sharded": {
                "supported": False,
                "detail": (
                    "runs the per-chunk sharded step: the expansion, the "
                    "exchange (compressed on the card with the overlap "
                    "layer) and the owners' dedup are one step per chunk "
                    "in this engine, so there is no separate fused variant — "
                    "the name runs the per-chunk path (identical results)"
                ),
            },
        },
    },
    "legacy": {
        "launches": "one K1 launch per chunk (and one K2 on device-hash)",
        "description": (
            "the JAX package's per-action step with its compaction ladder; "
            "the port's action kernels already evaluate every cell in one "
            "batched call, so 'legacy' runs the same per-chunk "
            "implementation as 'fused' and gives the same result (the name "
            "is kept so the JAX package's command lines run unchanged)"
        ),
        "fallback": None,
        "backends": {
            "device": {
                "supported": True,
                "detail": "the per-chunk sorted dedup on the card, as 'fused'",
            },
            "host": {
                "supported": True,
                "detail": "per-chunk host FpSet insert, as 'fused'",
            },
            "device-hash": {
                "supported": True,
                "detail": "per-chunk insert-or-find on the table on the card (K2), as 'fused'",
            },
        },
        "engines": {
            "single-device": {
                "supported": True,
                "detail": "the same per-chunk path as 'fused'",
            },
            "sharded": {
                "supported": True,
                "detail": (
                    "the per-chunk sharded step (parallel/sharded.py): K1 on "
                    "each shard's chunk, the all_to_all (raw or compressed) "
                    "or all_gather exchange, each owner's dedup (K2 on "
                    "device-hash; the host set, staged a chunk behind, or "
                    "the disk tier on host) — this engine's bit-identity "
                    "oracle path"
                ),
            },
        },
    },
}

PIPELINES = tuple(PIPELINE_REGISTRY)
DEFAULT_PIPELINE = "fused"

# the JAX package's support-matrix detail of ("device", "device-hash"),
# prefixed as its backend_fallback_reason does
DEVICE_HASH_REASON = (
    "visited backend 'device-hash': "
    + PIPELINE_REGISTRY["device"]["backends"]["device-hash"]["detail"]
)


def pipeline_names() -> tuple:
    return PIPELINES


def backend_support(name: str, backend: str) -> dict:
    """The (pipeline, backend) support cell: {"supported": bool,
    "detail": str}.  `backend` must be one of :data:`BACKENDS`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown visited backend {backend!r} (expected one of {BACKENDS})")
    if name not in PIPELINE_REGISTRY:
        raise ValueError(f"unknown pipeline {name!r} (expected one of {PIPELINES})")
    return PIPELINE_REGISTRY[name]["backends"][backend]


def engine_support(name: str, engine: str) -> dict:
    """The (pipeline, engine) support cell: {"supported": bool,
    "detail": str}.  `engine` must be one of :data:`ENGINES`."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
    if name not in PIPELINE_REGISTRY:
        raise ValueError(f"unknown pipeline {name!r} (expected one of {PIPELINES})")
    return PIPELINE_REGISTRY[name]["engines"][engine]


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


def list_pipelines() -> list:
    """The registry as ``cli pipelines --list/--json`` prints it."""
    return [
        {"name": name, "default": name == DEFAULT_PIPELINE, **entry}
        for name, entry in PIPELINE_REGISTRY.items()
    ]
