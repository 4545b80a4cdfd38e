"""Segment sums over sorted ids by blocked cumulative sums (port of
``mpm_tpu.ops.segsum``).

A segment [s, e) no longer than the block crosses at most one block
boundary, so with L the within-block inclusive cumsum, T the block totals
and head the within-block prefix before s:

    sum = L[e-1] - head                      (same block)
    sum = T[b_s] - head + L[e-1]             (adjacent blocks)

No global prefix is formed. Float contributions are summed in float64 and
each segment's sum is rounded once to float32: the prefix sums of a block
in float32 (the JAX package's, whose XLA tree-scans them, or torch's, which
rounds each prefix) differ from the oracle's per-cell sums in the last bit
of 1% of dam_break_2d's positions after one substep; in float64 the two
engines agree there bit for bit. int32 fixed point is exact, its sums
wrapping as XLA's do. No segment may exceed the block. Contributions are
[..., N], segments run along the last axis; outputs are [..., S].
"""

from __future__ import annotations

import torch


def sorted_segment_sum(contrib: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                       block: int = 1024) -> torch.Tensor:
    """The sum of contrib[..., s:e] for each segment (starts[i], ends[i]);
    segments are contiguous and at most `block` long. [..., S]."""
    if contrib.is_floating_point() and contrib.dtype != torch.float64:
        return sorted_segment_sum(contrib.double(), starts, ends, block).to(contrib.dtype)
    n = contrib.shape[-1]
    nb = -(-n // block)
    lead = contrib.shape[:-1]
    xb = torch.nn.functional.pad(contrib, (0, nb * block - n)).reshape(*lead, nb, block)
    lb = torch.cumsum(xb, dim=-1, dtype=contrib.dtype)
    t = lb[..., -1]  # [..., nb] block totals
    flat = lb.reshape(*lead, nb * block)

    s = starts.long()
    e = ends.long()
    bi = s // block
    last_i = torch.clamp_min(e - 1, 0)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    head = torch.where(s % block == 0, zero, flat[..., torch.clamp_min(s - 1, 0)])
    last = flat[..., last_i]
    same = bi == (last_i // block)
    # an empty segment may start at N, past the last block; its sum is masked
    total = torch.where(same, last - head, t[..., torch.clamp_max(bi, nb - 1)] - head + last)
    return torch.where(e > s, total, torch.zeros_like(total))


def segment_bounds_for_offset(seg_start: torch.Tensor, flat_offset: int, num_cells: int):
    """(starts, ends) of the segment of cell c - flat_offset for every cell
    c: on a row-major grid a tap moves the cell ids by a constant flat
    offset, so the tap's receiving segment for cell c is the particle
    segment of c - offset. Cells out of range get empty segments."""
    c = torch.arange(num_cells, dtype=torch.int64, device=seg_start.device) - flat_offset
    valid = (c >= 0) & (c < num_cells)
    cc = torch.clamp(c, 0, num_cells - 1)
    zero = torch.zeros((), dtype=seg_start.dtype, device=seg_start.device)
    s = torch.where(valid, seg_start[cc], zero)
    e = torch.where(valid, seg_start[cc + 1], zero)
    return s, e
