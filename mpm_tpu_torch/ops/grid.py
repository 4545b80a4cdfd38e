"""Grid momentum -> velocity update with gravity and boundary conditions
(port of ``mpm_tpu.ops.grid``; reference update_grid.glsl:36-74). Axis
indices come from the flat cell id (`x = i / gs / gs; y = i / gs % gs;
z = i % gs`, update_grid.glsl:61-63); band positions use the true domain
`dres`, so a windowed grid gets the full grid's walls."""

from __future__ import annotations

import torch

from ..core.params import BC_FRICTION, BC_SLIP, BC_STICK, FluidParams, SimConfig
from ..core.state import Grid
from . import fixed_point


def axis_indices(config: SimConfig, device: torch.device | str,
                 x0: int = 0) -> list[torch.Tensor]:
    """Per-axis cell index arrays, each [num_cells] int32, from the flat id;
    axis 0 offset by x0, the global plane of array plane 0 on a slab."""
    i = torch.arange(config.num_cells, dtype=torch.int32, device=device)
    out = []
    stride = config.num_cells
    for a in range(config.dim):
        stride //= config.grid_res[a]
        out.append((i // stride) % config.grid_res[a] + (x0 if a == 0 else 0))
    return out


def boundary_bands(config: SimConfig, device: torch.device | str,
                   x0: int = 0) -> list[torch.Tensor]:
    """Per-axis boolean masks, each [num_cells]: global index < bc_band_lo
    or > dres - 1 - bc_band_hi."""
    idxs = axis_indices(config, device, x0)
    return [
        (idxs[a] < config.bc_band_lo)
        | (idxs[a] > config.dres[a] - 1 - config.bc_band_hi)
        for a in range(config.dim)
    ]


def update_grid(grid: Grid, config: SimConfig, fp: FluidParams, x0: int = 0) -> Grid:
    """momentum -> velocity, gravity, boundary conditions. The returned
    `mom` holds grid velocities (update_grid.glsl:44-56). On a slab x0 is
    the global plane of the grid's plane 0 (the bands are global)."""
    if config.fixed_point:
        mass = fixed_point.decode(grid.mass, config.fixed_point_mult, config.dtype)
        mom = fixed_point.decode(grid.mom, config.fixed_point_mult, config.dtype)
    else:
        mass, mom = grid.mass, grid.mom
    device = mom.device

    has_mass = mass > 0
    safe_mass = torch.where(has_mass, mass, 1.0)
    dtg = (fp.dt * fp.gravity).to(device)
    vel = mom / safe_mass + dtg[:, None]  # [D, num_cells]

    bands = boundary_bands(config, device, x0)
    if config.bc == BC_SLIP:
        vel = torch.stack(
            [torch.where(bands[a], 0.0, vel[a]) for a in range(config.dim)]
        )
    elif config.bc == BC_STICK:
        any_band = bands[0]
        for a in range(1, config.dim):
            any_band = any_band | bands[a]
        vel = torch.where(any_band, 0.0, vel)
    elif config.bc == BC_FRICTION:
        # inside axis-a's band the normal component is zeroed and the
        # tangential ones scaled by `friction`, axis after axis
        # (MLSMPM2DFluidMultithread.cs:364-368)
        friction = torch.tensor(config.friction, dtype=vel.dtype, device=device)
        for a in range(config.dim):
            scale = torch.where(bands[a], friction, 1.0)
            vel = torch.stack([
                torch.where(bands[a], 0.0, vel[i]) if i == a else vel[i] * scale
                for i in range(config.dim)
            ])
    else:
        raise ValueError(f"unknown bc flavor: {config.bc}")

    vel = torch.where(has_mass, vel, 0.0)

    if config.fixed_point:
        vel = fixed_point.encode(vel, config.fixed_point_mult)
    return Grid(mom=vel, mass=grid.mass)
