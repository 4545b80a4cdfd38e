"""The oracle: the per-substep sequence by dense scatter and gather, D-generic
(port of ``mpm_tpu.ops.reference``).

    ClearGrid -> P2G_1 -> P2G_2 -> UpdateGrid -> G2P

(MLSMPM2DFluid.cs:166-182, MLSMPM3DFluidMultithreadGPU.cs:505-544) on a
linear SimState: a scatter-add of each tap's contributions for P2G, a
gather of each tap's node for G2P. The other engines are held to it
(ops/binned.py, ops/bucketed.py).

The scatter adds in particle order. On the CPU `index_add_` does so; on a
card `index_add_` uses float atomics, whose order changes from run to run,
so the accumulating `index_put_` runs there (it sorts the indices stably
and adds each cell's run in one pass, the same bits on every call).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.params import FluidParams, SimConfig
from ..core.state import Grid, SimState, zero_grid
from . import bspline, fixed_point, stress, transfer
from .grid import update_grid
from .interact import Interaction, apply_interactions


def encode_maybe(x: torch.Tensor, config: SimConfig) -> torch.Tensor:
    """Fixed point encodes each tap's contribution before it is added, as
    the reference's per-atomicAdd encode (p2g_1.glsl:87-90)."""
    if config.fixed_point:
        return fixed_point.encode(x, config.fixed_point_mult)
    return x


def decode_maybe(x: torch.Tensor, config: SimConfig) -> torch.Tensor:
    if config.fixed_point:
        return fixed_point.decode(x, config.fixed_point_mult, config.dtype)
    return x


def weighted_decode(w: torch.Tensor, x: torch.Tensor, config: SimConfig) -> torch.Tensor:
    """A tap's weighted grid value, w * decode_maybe(x)."""
    return w * decode_maybe(x, config)


def scatter_add(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """target[..., idx[i]] += values[..., i] along the last axis, in place,
    deterministic on every device (the module docstring)."""
    idx = idx.long()
    if target.device.type == "cpu":
        return target.index_add_(target.dim() - 1, idx, values)
    rows = target.view(-1, target.shape[-1])
    vals = values.reshape(-1, values.shape[-1])
    for r in range(rows.shape[0]):
        rows[r].index_put_((idx,), vals[r], accumulate=True)
    return target


def _gather_index(flat: torch.Tensor, off: int, config: SimConfig) -> torch.Tensor:
    """The tap's node ids, clamped into the grid as JAX clamps a gather
    (only the sharded step's dead slots, DEAD_CID, fall outside)."""
    return torch.clamp(flat.long() + off, 0, config.num_cells - 1)


def p2g_1(state: SimState, grid: Grid, geom: transfer.TransferGeometry,
          config: SimConfig) -> Grid:
    """Mass and APIC momentum scattered tap by tap (p2g_1.glsl:56-93)."""
    gmass, gmom = grid.mass.clone(), grid.mom.clone()
    for tap, off in zip(bspline.taps(config.dim), transfer.flat_tap_offsets(config)):
        mass_c, mom_c = transfer.p2g1_tap_contribs(state, geom.d, tap)
        idx = geom.flat_base + off
        scatter_add(gmass, idx, encode_maybe(mass_c, config))
        scatter_add(gmom, idx, encode_maybe(mom_c, config))
    return Grid(mom=gmom, mass=gmass)


def gather_density(state: SimState, grid: Grid, geom: transfer.TransferGeometry,
                   config: SimConfig) -> torch.Tensor:
    """Density: the sum of w * node mass over the neighbourhood
    (p2g_2.glsl:66-90). [N]."""
    density = torch.zeros_like(state.mass)
    for tap, off in zip(bspline.taps(config.dim), transfer.flat_tap_offsets(config)):
        w = bspline.tap_weight(geom.d, tap)
        gm = decode_maybe(grid.mass[_gather_index(geom.flat_base, off, config)], config)
        density = density + gm * w
    return density


def p2g_2(state: SimState, grid: Grid, geom: transfer.TransferGeometry, config: SimConfig,
          fp: FluidParams) -> Grid:
    """The EOS and viscosity force scattered tap by tap (p2g_2.glsl:52-159)."""
    density = gather_density(state, grid, geom, config)
    eq16 = stress.fused_force_term(density, state.mass, state.C, fp, config.legacy_strain)
    gmom = grid.mom.clone()
    for tap, off in zip(bspline.taps(config.dim), transfer.flat_tap_offsets(config)):
        mom_c = transfer.p2g2_tap_contribs(eq16, geom.d, tap)
        scatter_add(gmom, geom.flat_base + off, encode_maybe(mom_c, config))
    return Grid(mom=gmom, mass=grid.mass)


def g2p_gather(grid: Grid, geom: transfer.TransferGeometry, config: SimConfig):
    """Velocity gather and APIC B (g2p.glsl:73-108): (vel [D, N], C = 4B
    [D, D, N])."""
    dim = config.dim
    n = geom.d.shape[-1]
    vel = torch.zeros((dim, n), dtype=geom.d.dtype, device=geom.d.device)
    B = torch.zeros((dim, dim, n), dtype=geom.d.dtype, device=geom.d.device)
    for tap, off in zip(bspline.taps(dim), transfer.flat_tap_offsets(config)):
        w = bspline.tap_weight(geom.d, tap)
        dist = bspline.tap_dist(geom.d, tap)
        wv = weighted_decode(w, grid.mom[:, _gather_index(geom.flat_base, off, config)], config)
        vel = vel + wv
        B = B + wv[:, None, :] * dist[None, :, :]
    return vel, 4.0 * B


def g2p_tail(state: SimState, vel: torch.Tensor, C: torch.Tensor, config: SimConfig,
             fp: FluidParams, interactions: Sequence[Interaction] = ()) -> SimState:
    """Advection, clamps, interaction forces and the predictive wall springs
    (g2p.glsl:110-147, MLSMPM2DFluid.cs:375-416)."""
    pos = state.pos + vel * fp.dt
    pos = torch.stack([torch.clamp(pos[a], config.clamp_lo, config.dres[a] - config.clamp_hi_offset)
                       for a in range(config.dim)])
    res = torch.tensor(config.dres, dtype=torch.float32, device=pos.device).reshape(-1, 1)
    vel = apply_interactions(pos, vel, interactions)
    x_n = pos + vel
    hi = res - config.wall_max_offset
    vel = vel + config.wall_stiffness * (torch.clamp_min(config.wall_min - x_n, 0.0)
                                         + torch.clamp_max(hi - x_n, 0.0))
    return SimState(pos=pos, vel=vel, C=C, mass=state.mass, ids=state.ids)


def g2p(state: SimState, grid: Grid, geom: transfer.TransferGeometry, config: SimConfig,
        fp: FluidParams, interactions: Sequence[Interaction] = ()) -> SimState:
    vel, C = g2p_gather(grid, geom, config)
    return g2p_tail(state, vel, C, config, fp, interactions)


def substep(state: SimState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> SimState:
    """One substep of the normative algorithm."""
    geom = transfer.geometry(state.pos, config)
    grid = zero_grid(config, state.pos.device)
    grid = p2g_1(state, grid, geom, config)
    grid = p2g_2(state, grid, geom, config, fp)
    grid = update_grid(grid, config, fp)
    return g2p(state, grid, geom, config, fp, interactions)
