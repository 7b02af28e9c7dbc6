"""kafka_specification_tpu_torch: the model checker ported to PyTorch and CUDA.

A second package beside ``kafka_specification_tpu`` (the JAX reference,
which it never imports).  It reads a TLC ``.cfg``, builds the tensor model
of a Kafka replication spec, runs the breadth-first check on an NVIDIA
Hopper card and reports the verdict with a counterexample trace.  The two
hot kernels of the JAX package's device-hash path are hand-written CUDA:

    ops/cuda_fingerprint.py   K1, murmur3 fingerprints  (csrc/fingerprint.cu)
    ops/cuda_hashset.py       K2, hash-table insert-or-find (csrc/hashset.cu)

and the TPU construct ladder's six rungs have theirs, off the check path:

    ops/cuda_ladder.py        K4, one construct per rung (csrc/ladder.cu)

Every entry point runs on the card unless the caller passes device="cpu",
where the kernels' plain PyTorch versions run instead.

Layout (module names mirror the JAX package):
    ops/       packing, fingerprints, dedup and the sorted set, the hash
               set, the device level's digest and appends (devlevel.py),
               kernels + build
    models/    tensor encodings and batched action/invariant kernels: the
               Kafka replication family, AsyncIsr, IdSequence, FRL, and
               the partition product (product.py)
    engine/    the BFS checker (bfs.py: the level loop, its run options,
               checkpoints and the sorted, hash and host visited sets;
               pipeline.py: the per-chunk stages, the candidate order and
               the device-resident level pipeline)
               and random simulation (simulate.py, TLC's -simulate);
               decode.py turns collected levels into canonical states
    oracle/    the reference interpreter: each model's set semantics in
               plain Python (the models' make_oracle twins), sharing no
               code with the kernels
    analysis/  the encoding gate and proven field hulls (interval
               abstract interpretation of the action kernels), and the
               ownership and purity passes over the engine sources
    native/    the host fingerprint set (fpset.cpp, g++ at first use)
    resilience/  the level digest chain, the checkpoint store, the
               per-level heartbeat record
    durable_io.py  the file steps checkpoints and stats lines take
    utils/     TLC .cfg parsing and model instantiation, trace rendering,
               device timing
    cli.py     `python -m kafka_specification_tpu_torch.cli check|simulate|oracle CFG`,
               and `report`, `faults`, `pipelines`, `analyze`, `verify-checkpoint`
    verdict.py the kspec-verdict/1 record and exit codes
    pipeline_registry.py  pipeline names ("fused", "legacy", "device"),
               their per-engine and per-backend support and $KSPEC_PIPELINE
    interop.py JAX/numpy state -> the port's tensors (used by the tests)
"""

__version__ = "0.1.0"


def check(*args, **kwargs):
    """Single-device exhaustive check (see engine.bfs.check)."""
    from .engine.bfs import check as _check

    return _check(*args, **kwargs)


def load_config(path):
    """Parse a TLC .cfg file (see utils.cfg.parse_cfg)."""
    from .utils.cfg import parse_cfg

    return parse_cfg(path)


def build_model(module, cfg, oracle=False):
    """Instantiate a model (or, with oracle=True, its set-semantics twin)
    from a TLA+ module name and a parsed TLC config (see
    utils.cfg.build_model)."""
    from .utils.cfg import build_model as _build_model

    return _build_model(module, cfg, oracle=oracle)
