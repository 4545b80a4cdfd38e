"""K-slot binning of sorted particles (port of ``mpm_tpu.ops.binning``).

The binned engine (ops/binned.py) needs no capacity; this packs the
particles of each cell into a fixed [num_cells, K] slot table from the
sorted path's segment starts, by gathers only. A cell holding more than K
particles leaves the excess unbinned and counts it in `overflow`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.params import SimConfig


class BinnedSlots(NamedTuple):
    """slot_particle[c, k]: the index into the sorted particle arrays of
    the k-th particle of cell c, or N (the guard) for an empty slot."""

    slot_particle: torch.Tensor  # [num_cells, K] int32
    slot_valid: torch.Tensor  # [num_cells, K] bool
    count: torch.Tensor  # [num_cells] particles a cell
    overflow: torch.Tensor  # int32 scalar


def bin_slots(seg_start: torch.Tensor, config: SimConfig, n: int) -> BinnedSlots:
    """The slot table from the segment starts [num_cells + 1]."""
    k = config.bin_capacity
    count = seg_start[1:] - seg_start[:-1]
    ks = torch.arange(k, dtype=torch.int32, device=seg_start.device)
    idx = (seg_start[:-1, None] + ks[None, :]).to(torch.int32)
    valid = ks[None, :] < count[:, None]
    return BinnedSlots(slot_particle=torch.where(valid, idx, n), slot_valid=valid, count=count,
                       overflow=torch.clamp_min(count - k, 0).sum().to(torch.int32))


def _padded(field: torch.Tensor) -> torch.Tensor:
    guard = torch.zeros((*field.shape[:-1], 1), dtype=field.dtype, device=field.device)
    return torch.cat([field, guard], dim=-1)


def gather_slot_field(field: torch.Tensor, slots: BinnedSlots) -> torch.Tensor:
    """A per-particle field [..., N] packed into [..., num_cells, K] (guard
    slots read 0)."""
    return _padded(field)[..., slots.slot_particle.long()]


def gather_slot_field_kc(field: torch.Tensor, slots: BinnedSlots) -> torch.Tensor:
    """A per-particle field [..., N] packed into [..., K, num_cells], the
    bucket engine's layout."""
    return _padded(field)[..., slots.slot_particle.T.long()]
