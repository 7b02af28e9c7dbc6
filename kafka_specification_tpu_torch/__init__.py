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
    ops/       packing, fingerprints, dedup, the hash set, kernels + build
    models/    tensor encodings and batched action/invariant kernels
    engine/    the BFS checker (device-hash visited set, legacy step)
    utils/     TLC .cfg parsing and model instantiation; device timing
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


def build_model(module, cfg):
    """Instantiate a model from a TLA+ module name and a parsed TLC config."""
    from .utils.cfg import build_model as _build_model

    return _build_model(module, cfg)
