"""The sorted engine: a sort by cell id and per-tap segment sums (port of
``mpm_tpu.ops.binned``).

Particles are sorted by flat cell id once a substep. On a row-major grid
each of the 3^D taps sends a particle to `cid + const_offset`, so the
particles feeding any node form a contiguous range of the sorted arrays:
each P2G pass is 3^D segment sums by blocked cumsums (ops/segsum.py), with
no scatter. G2P gathers per particle (ops/reference.py).

The returned state is in sorted order; `ids` keeps the emission index
(SimState.by_id() restores it).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.params import FluidParams, SimConfig
from ..core.state import Grid, SimState, zero_grid
from . import bspline, stress, transfer
from .grid import update_grid
from .interact import Interaction
from .reference import encode_maybe, g2p, gather_density
from .segsum import segment_bounds_for_offset, sorted_segment_sum


def sort_by_cell(state: SimState, config: SimConfig):
    """(state sorted by flat cell id, seg_start [num_cells + 1]):
    seg_start[c] is the index of the first particle of cell c (a stable
    sort, then a binary search of every cell id)."""
    cid = transfer.geometry(state.pos, config).flat_base
    order = torch.argsort(cid, stable=True)
    state = state.permute(order)
    cid_s = cid[order]
    cells = torch.arange(config.num_cells + 1, dtype=cid_s.dtype, device=cid_s.device)
    return state, torch.searchsorted(cid_s, cells).to(torch.int32)


def segsum_block(config: SimConfig) -> int:
    """Fixed-point cumsums must keep |block * mult * contribution| < 2^31."""
    return 128 if config.fixed_point else 1024


def p2g_pass1(state: SimState, geom: transfer.TransferGeometry, seg_start: torch.Tensor,
              config: SimConfig) -> Grid:
    """P2G pass 1 (p2g_1.glsl): mass and APIC momentum, scatter-free."""
    block = segsum_block(config)
    grid0 = zero_grid(config, state.pos.device)
    gmass, gmom = grid0.mass, grid0.mom
    for tap, off in zip(bspline.taps(config.dim), transfer.flat_tap_offsets(config)):
        mass_c, mom_c = transfer.p2g1_tap_contribs(state, geom.d, tap)
        s, e = segment_bounds_for_offset(seg_start, off, config.num_cells)
        gmass = gmass + sorted_segment_sum(encode_maybe(mass_c, config), s, e, block=block)
        gmom = gmom + sorted_segment_sum(encode_maybe(mom_c, config), s, e, block=block)
    return Grid(mom=gmom, mass=gmass)


def p2g_pass2(state: SimState, geom: transfer.TransferGeometry, seg_start: torch.Tensor,
              grid: Grid, config: SimConfig, fp: FluidParams) -> Grid:
    """P2G pass 2 (p2g_2.glsl): the density gather and the EOS / viscosity
    force, scatter-free. `grid.mass` must hold the whole neighbourhood's
    mass (on a slab: after the halo exchange)."""
    block = segsum_block(config)
    density = gather_density(state, grid, geom, config)
    eq16 = stress.fused_force_term(density, state.mass, state.C, fp, config.legacy_strain)
    gmom = grid.mom
    for tap, off in zip(bspline.taps(config.dim), transfer.flat_tap_offsets(config)):
        mom_c = transfer.p2g2_tap_contribs(eq16, geom.d, tap)
        s, e = segment_bounds_for_offset(seg_start, off, config.num_cells)
        gmom = gmom + sorted_segment_sum(encode_maybe(mom_c, config), s, e, block=block)
    return Grid(mom=gmom, mass=grid.mass)


def p2g(state: SimState, geom: transfer.TransferGeometry, seg_start: torch.Tensor,
        config: SimConfig, fp: FluidParams) -> Grid:
    """Both P2G passes."""
    grid = p2g_pass1(state, geom, seg_start, config)
    return p2g_pass2(state, geom, seg_start, grid, config, fp)


def substep(state: SimState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> SimState:
    """One substep of the normative algorithm on the sorted engine."""
    state, seg_start = sort_by_cell(state, config)
    geom = transfer.geometry(state.pos, config)
    grid = p2g(state, geom, seg_start, config, fp)
    grid = update_grid(grid, config, fp)
    return g2p(state, grid, geom, config, fp, interactions)
