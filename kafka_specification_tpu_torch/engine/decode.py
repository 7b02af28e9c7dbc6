"""Packed BFS levels -> the model's canonical Python states.

``check(collect_levels=...)`` hands back each level as packed rows,
int64[n, K], on the device the check ran on.  ``decode_rows`` unpacks a
level there, copies it to the host in one transfer and decodes each row
with ``model.decode``, so a level becomes the same canonical values the
reference interpreter (``oracle/``) and the JAX package's decoder give:
engine and oracle levels then compare as sets with ``==``.

The decoded values hold no reference cycles, so the cyclic garbage
collector is paused while a level is decoded: beside a large live heap
(an oracle's level sets) its full passes would otherwise more than double
the decode's time.
"""

from __future__ import annotations

import gc

import torch

from ..models.base import Model


def decode_rows(model: Model, packed: torch.Tensor) -> list:
    """Packed rows, int64[n, K] on any device -> their decoded states, in
    row order.  The unpack runs on the rows' device; the level's fields
    cross to the host as one int64[n, E] tensor."""
    spec = model.spec
    n = packed.shape[0]
    fields = spec.unpack(packed)
    flat = torch.cat([fields[f.name].reshape(n, f.num_elements) for f in spec.fields], dim=1)
    host = flat.cpu()  # the level's one copy to the host
    cols, at = [], 0
    for f in spec.fields:
        cols.append(host[:, at : at + f.num_elements].reshape(n, *f.shape).tolist())
        at += f.num_elements
    names = [f.name for f in spec.fields]
    decode = model.decode
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return [decode(dict(zip(names, vals))) for vals in zip(*cols)]
    finally:
        if was_enabled:
            gc.enable()


def decode_levels(model: Model, packed_levels) -> list:
    """``collect_levels`` output -> one set of decoded states per level."""
    return [set(decode_rows(model, p)) for p in packed_levels]
