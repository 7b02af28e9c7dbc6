"""Carry state across from the JAX package into the port's tensors.

The port imports nothing of the JAX package; these helpers take what it
produces as numpy-convertible arrays (a JAX array converts through
``np.asarray``) and build the port's tensors on a given device:

- a visited table ``(t_hi, t_lo)`` from ``hashset.table_from_pairs`` ->
  the port's one-word-per-slot table, slot for slot;
- packed frontier rows (uint32 lanes), and any other uint32 array such as
  fingerprint lanes -> int64 tensors of the same u32 values;
- a ``kafka_replication.Config`` or an ``AsyncIsrConfig`` -> the port's.

The tests use them to start the port from exactly the JAX package's state,
and the engine to read and write checkpoint arrays (uint32 in the file).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.async_isr import AsyncIsrConfig
from .models.kafka_replication import Config
from .ops import dedup


def from_u32(a, device) -> torch.Tensor:
    """uint32 array (e.g. packed rows uint32[M, K]) -> int64 tensor of the
    same u32 values on `device`."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u32 values -> uint32 numpy array."""
    return t.cpu().numpy().astype(np.uint32)


def table_from_jax(t_hi, t_lo, device) -> torch.Tensor:
    """JAX (t_hi, t_lo) uint32[cap] table -> the port's int64[cap] table
    with every key in the same slot."""
    return dedup.pair_key(from_u32(t_hi, device), from_u32(t_lo, device))


def table_to_pairs(table: torch.Tensor):
    """The port's table -> (t_hi, t_lo) uint32 numpy arrays, slot for slot."""
    hi, lo = dedup.split_key(table)
    return to_u32(hi), to_u32(lo)


def config_from_jax(cfg) -> Config:
    """A JAX-package Config (any object with the four constants)."""
    return Config(
        n_replicas=cfg.n_replicas,
        log_size=cfg.log_size,
        max_records=cfg.max_records,
        max_leader_epoch=cfg.max_leader_epoch,
    )


def async_isr_config_from_jax(cfg) -> AsyncIsrConfig:
    """A JAX-package AsyncIsrConfig (any object with its three constants)."""
    return AsyncIsrConfig(
        n_replicas=cfg.n_replicas, max_offset=cfg.max_offset, max_version=cfg.max_version
    )
