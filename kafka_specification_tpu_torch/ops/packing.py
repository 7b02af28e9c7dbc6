"""Fixed-width bit packing of model states into 32-bit lanes (PyTorch).

Counterpart of ``kafka_specification_tpu/ops/packing.py``: the same lane
layout, element for element, so a state packs to the same lane values in
both packages.  A model checker dedups states by identity, so the encoding
is canonical: one TLA+ state <-> exactly one bit pattern.

Each field is an integer tensor with a known inclusive value range
[lo, hi].  Values are stored biased (v - lo) in ceil(log2(hi-lo+1)) bits,
and elements never straddle a lane boundary (the packer pads instead).

Carrier: every tensor here is ``torch.int64``.  A lane holds an unsigned
32-bit value in [0, 2^32); field values are plain signed integers.  (torch
has no usable ``uint32`` arithmetic on the CPU, so the whole port carries
u32 values in int64.)  ``pack`` and ``unpack`` work on any number of
leading batch dimensions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class Field:
    """One state variable: an integer tensor of `shape` with values in [lo, hi]."""

    name: str
    shape: tuple[int, ...]
    lo: int
    hi: int

    def __post_init__(self):
        if self.hi < self.lo:
            raise ValueError(f"field {self.name}: hi {self.hi} < lo {self.lo}")

    @property
    def width(self) -> int:
        span = self.hi - self.lo + 1
        return max(1, math.ceil(math.log2(span)))

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1


class StateSpec:
    """Bit-layout codec for a tuple of Fields -> int64[..., num_lanes]."""

    def __init__(self, fields: Sequence[Field], force_hashed: bool = False):
        self.fields = tuple(fields)
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")

        lane_ids, shifts, widths, los = [], [], [], []
        lane, bit = 0, 0
        lane_bits = {}
        for f in self.fields:
            w = f.width
            if w > 32:
                raise ValueError(f"field {f.name} needs {w} bits > 32")
            for _ in range(f.num_elements):
                if bit + w > 32:  # never straddle a lane
                    lane, bit = lane + 1, 0
                lane_ids.append(lane)
                shifts.append(bit)
                widths.append(w)
                los.append(f.lo)
                bit += w
                lane_bits[lane] = bit
        self.num_lanes = lane + 1 if bit > 0 else lane
        # a state can pack to the all-ones sentinel pair (the dedup
        # empty-slot marker) only if there are exactly two lanes, both full
        # of field bits, and every field's biased span reaches its all-ones
        # pattern; such a layout is demoted to hashed fingerprints
        spans_full = all(f.hi - f.lo + 1 == (1 << f.width) for f in self.fields)
        self._may_hit_sentinel = (
            self.num_lanes == 2
            and all(lane_bits.get(i, 0) == 32 for i in range(self.num_lanes))
            and spans_full
        )
        self.total_bits = sum(widths)
        self._lane_ids = lane_ids
        self._shifts = shifts
        self._masks = [(1 << w) - 1 for w in widths]
        self._los = los
        self._field_slices = {}
        ofs = 0
        for f in self.fields:
            self._field_slices[f.name] = (ofs, ofs + f.num_elements, f.shape)
            ofs += f.num_elements
        # True iff the whole state fits in 64 bits: the fingerprint is then
        # the state itself (collision-free dedup)
        self.exact64 = (
            self.num_lanes <= 2 and not force_hashed and not self._may_hit_sentinel
        )
        self._consts = {}

    def _layout(self, device: torch.device):
        """Per-element (lane, shift, mask, lo) as int64 tensors on `device`,
        plus the element indices of each lane."""
        key = str(device)
        if key not in self._consts:
            per_elem = tuple(
                torch.tensor(v, dtype=torch.int64, device=device)
                for v in (self._lane_ids, self._shifts, self._masks, self._los)
            )
            members = [
                torch.tensor(
                    [i for i, l in enumerate(self._lane_ids) if l == k],
                    dtype=torch.int64,
                    device=device,
                )
                for k in range(self.num_lanes)
            ]
            self._consts[key] = (*per_elem, members)
        return self._consts[key]

    def flatten(self, state: dict) -> torch.Tensor:
        """dict of int64[*batch, *field.shape] -> int64[*batch, elements]."""
        parts = []
        for f in self.fields:
            v = state[f.name]
            batch = v.shape[: v.dim() - len(f.shape)]
            parts.append(v.reshape((*batch, f.num_elements)))
        return torch.cat(parts, dim=-1)

    def unflatten(self, flat: torch.Tensor) -> dict:
        batch = flat.shape[:-1]
        return {
            f.name: flat[..., a:b].reshape((*batch, *shape))
            for f in self.fields
            for a, b, shape in [self._field_slices[f.name]]
        }

    def pack(self, state: dict) -> torch.Tensor:
        """dict of int64[*batch, *shape] -> int64[*batch, num_lanes] (u32 values)."""
        flat = self.flatten(state)
        _, shifts, masks, los, members = self._layout(flat.device)
        shifted = ((flat - los) & masks) << shifts
        # widths do not overlap within a lane, so a sum is a bitwise or
        return torch.stack(
            [shifted.index_select(-1, idx).sum(dim=-1) for idx in members],
            dim=-1,
        )

    def unpack(self, lanes: torch.Tensor) -> dict:
        """int64[*batch, num_lanes] -> dict of int64[*batch, *shape]."""
        lane_ids, shifts, masks, los, _ = self._layout(lanes.device)
        vals = (lanes[..., lane_ids] >> shifts) & masks
        return self.unflatten(vals + los)
