"""The yardstick of the sharded cell's kernels, beside bench_torch/roofline.py
(imported, not changed): the work of kernel P's two shard stages and of
kernel F in shard mode on a padded slab, as the program's
utils/roofline.p2g1_shard_work, p2g2u_shard_work and g2p_migrate_work count
it, copied when the cell was defined so that a change to the program cannot
move it.

A padded slab is what the stages and F run on: the slab's own planes with
its neighbours' HALO nearest planes a side (dead planes past the global
ends); its grid has one plane more a side. `padded_slabs` builds, from the
slabs' own arrays, each padded slab's mass (which says which slots are
occupied) by a plain torch.cat, and its other arrays as shapes alone (on
the meta device: the bytes count their sizes, never their values)."""

from __future__ import annotations

import types

import torch

from .roofline import (_coef_ops, _g2p_ops, _migrate_ops, _nbytes, _occupied, _occupied_cells,
                       _p2g1_ops, _p2g2_ops, _slot_bytes, _weight_ops, bound_ms)

HALO = 2  # state planes a side a slab takes from each neighbour
DIM = 3


def padded_slabs(slabs: list, plane_cells: int) -> list:
    """A namespace (pos, vel, C, mass, ids, cells) a slab of `slabs` (own
    planes, [..., K, L * plane_cells] arrays), padded as the program pads
    it; `cells` is its padded cell count."""
    h = HALO * plane_cells
    out = []
    for a, s in enumerate(slabs):
        m = s.mass
        lo = slabs[a - 1].mass[..., -h:].to(m.device) if a > 0 else m.new_zeros((*m.shape[:-1], h))
        hi = (slabs[a + 1].mass[..., :h].to(m.device) if a < len(slabs) - 1
              else m.new_zeros((*m.shape[:-1], h)))
        cells = m.shape[-1] + 2 * h

        def meta(t):
            return torch.empty((*t.shape[:-1], cells), dtype=t.dtype, device="meta")

        out.append(types.SimpleNamespace(pos=meta(s.pos), vel=meta(s.vel), C=meta(s.C),
                                         mass=torch.cat([lo, m, hi], dim=-1), ids=meta(s.ids),
                                         cells=cells, grid_cells=cells + 2 * plane_cells))
    return out


def p2g1_shard_work(padded) -> tuple[int, int]:
    """(bytes, operations) of stage 1: mass, and pos, vel and C of the
    occupied slots in; the grid mass and pass-1 momentum of the slab's grid
    out (float32 grids)."""
    n = _occupied(padded)
    nbytes = (_nbytes(padded.mass) + _slot_bytes(n, padded.pos, padded.vel, padded.C)
              + 4 * padded.grid_cells * (DIM + 1))
    return nbytes, n * (_weight_ops(DIM) + _p2g1_ops(DIM))


def p2g2u_shard_work(padded) -> tuple[int, int]:
    """(bytes, operations) of stage 2: mass, and pos and C of the occupied
    slots, the grid mass of every grid cell and the pass-1 momentum of the
    occupied cells in; the grid velocity out. The update counts 4D
    operations a cell that holds a slot (the full strain)."""
    n, cells, gc = _occupied(padded), _occupied_cells(padded), padded.grid_cells
    nbytes = (_nbytes(padded.mass) + _slot_bytes(n, padded.pos, padded.C) + 4 * gc
              + 4 * DIM * cells + 4 * DIM * gc)
    ops = n * (_weight_ops(DIM) + _coef_ops(DIM) + _p2g2_ops(DIM, False)) + cells * 4 * DIM
    return nbytes, ops


def g2p_shard_work(padded) -> tuple[int, int]:
    """(bytes, operations) of kernel F in shard mode, without interactions
    or emission: mass, and pos and ids of the occupied slots and the grid
    velocity of their cells in; the padded state out."""
    n = _occupied(padded)
    nbytes = (_nbytes(padded.mass) + _slot_bytes(n, padded.pos, padded.ids)
              + 4 * DIM * _occupied_cells(padded)
              + _nbytes(padded.pos, padded.vel, padded.C, padded.mass, padded.ids))
    return nbytes, n * (_weight_ops(DIM) + _g2p_ops(DIM, 0) + _migrate_ops(DIM))


def bound_s(slabs: list, plane_cells: int, *works) -> float:
    """The least seconds an H100 could take for the `works` of every padded
    slab of `slabs`: each launch's bound, summed."""
    return sum(bound_ms(*w(p))[0] for p in padded_slabs(slabs, plane_cells) for w in works) * 1e-3
