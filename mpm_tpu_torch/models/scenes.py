"""The 2D and 3D scenes of ``mpm_tpu.models.scenes`` as (SimConfig,
FluidParams, SimState) triples. Placement is numpy with the same seeds, so
the initial positions are array-equal to the JAX package's. Each scene
takes the `device` its state is created on: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.params import BC_FRICTION, BC_SLIP, FluidParams, SimConfig
from ..core.state import SimState, make_state
from .emitters import box_lattice


class Scene(NamedTuple):
    name: str
    config: SimConfig
    fluid: FluidParams
    state: SimState


def dam_break_2d(grid_res: int = 64, box: float = 32.0, spacing: float = 1.0,
                 device: torch.device | str = "cuda") -> Scene:
    """S1, the 2D serial variant (MLSMPM2DFluid.cs:22-40,126-141): 64^2
    grid, 32^2 box at spacing 1.0 -> 1,024 particles, dt 0.2, 5 substeps,
    eos_stiffness 10, eos_power 7, slip BC, gravity +y 0.3 (screen down),
    clamp [1, res-2], wall_min 2, stiffness 0.5, the legacy strain."""
    pos = box_lattice((grid_res, grid_res), (box, box), spacing)
    config = SimConfig(
        grid_res=(grid_res, grid_res),
        num_particles=pos.shape[0],
        substeps=5,
        bc=BC_SLIP,
        bc_band_lo=2,
        bc_band_hi=2,
        clamp_lo=1.0,
        clamp_hi_offset=2.0,
        wall_min=2.0,
        wall_max_offset=3.0,  # wall_max = res - 1 - wall_min
        wall_stiffness=0.5,
        legacy_strain=True,
        bin_capacity=8,
    )
    fluid = FluidParams.create(dim=2, dt=0.2, gravity=(0.0, 0.3), eos_stiffness=10.0,
                               eos_power=7.0)
    return Scene("dam_break_2d", config, fluid, make_state(pos, device))


def fluid_2d_friction(grid_res: int = 64, box: float = 32.0, spacing: float = 1.0,
                      device: torch.device | str = "cuda") -> Scene:
    """S2, the 2D multithreaded variant (MLSMPM2DFluidMultithread.cs:24-42,
    354-368): S1's scene with eos_power 4 and slip+friction walls (friction
    0.5, high band x > res-4)."""
    base = dam_break_2d(grid_res, box, spacing, device=device)
    config = base.config.replace(bc=BC_FRICTION, friction=0.5, bc_band_hi=3)
    fluid = dataclasses.replace(base.fluid, eos_power=torch.tensor(4.0))
    return Scene("fluid_2d_friction", config, fluid, base.state)


def benchmark_scene_2d(n_target: int = 100_000, grid_res: int = 256,
                       device: torch.device | str = "cuda") -> Scene:
    """The 2D benchmark pool at BASELINE.md's scale (100k particles, 256^2)
    with friction walls: uniform per-cell packing on the hydrostatic
    profile, as the 3D benchmark scene; 2D gravity is +y (screen down), so
    the pool rests at high y. A stiff EOS (k=30) keeps the bottom at most 3
    a cell, one slot of K=4 headroom."""
    m0 = 2
    g, k_eos, gamma = 0.3, 30.0, 4.0
    rho0 = float(m0)
    wcols = grid_res - 6  # x cells [3, res-3)
    height_rest = n_target / (m0 * wcols)

    rows = []
    placed = 0
    xi = 0.0
    while placed < n_target:
        s = (1.0 + g * rho0 * max(height_rest - xi, 0.0) / k_eos) ** (1.0 / gamma)
        m_r = int(np.clip(round(m0 * s), 1, 4))
        take = min(m_r * wcols, n_target - placed)
        rows.append((m_r, take))
        placed += take
        xi += m_r / m0

    config = SimConfig(
        grid_res=(grid_res, grid_res),
        num_particles=n_target,
        substeps=5,
        bc=BC_FRICTION,
        friction=0.5,
        bc_band_lo=2,
        bc_band_hi=3,
        clamp_lo=1.0,
        clamp_hi_offset=2.0,
        wall_min=2.0,
        wall_max_offset=3.0,
        wall_stiffness=0.5,
        legacy_strain=True,
        bin_capacity=4,
        eos_power_static=gamma,
    )
    fluid = FluidParams.create(dim=2, dt=0.05, gravity=(0.0, g), rest_density=rho0,
                               eos_stiffness=k_eos, eos_power=gamma)
    # sub-lattice per cell: m of 4 half-grid positions, rotating pattern
    corners = np.asarray([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                         np.float32)
    gx = 3.0 + np.arange(wcols, dtype=np.float32)
    rng = np.random.default_rng(777)
    parts = []
    y_floor = grid_res - 4  # the pool builds upward (decreasing y) from here
    for r, (m_r, take) in enumerate(rows):
        nfull = take // m_r
        rot = (np.arange(wcols) * 3 + r * 5) % 4
        base = np.stack([gx, np.full_like(gx, y_floor - 1 - r)], -1)
        sub = corners[(rot[:, None] + np.arange(m_r)[None, :]) % 4]
        pts = (base[:, None, :] + sub)[:nfull].reshape(-1, 2)
        rem = take - nfull * m_r
        if rem:
            pts = np.concatenate([pts, (base[nfull] + sub[nfull])[:rem]])
        parts.append(pts)
    pos = np.concatenate(parts, axis=0).astype(np.float32)
    pos += rng.uniform(-0.04, 0.04, pos.shape).astype(np.float32)
    assert pos.shape[0] == n_target
    return Scene(f"bench2d_{n_target}", config, fluid, make_state(pos, device))


def fluid_3d_cpu(grid_res: int = 32, box: float = 16.0, spacing: float = 0.5,
                 device: torch.device | str = "cuda") -> Scene:
    """S3, the 3D multithreaded CPU variant
    (MLSMPM3DFluidMultithread.cs:22-40,133-158): 32^3 grid, 16^3 box at
    spacing 0.5 -> 32,768 particles, 5 substeps, eos_stiffness 10,
    eos_power 4, clamp [1, res-2], wall_min 3 / wall_max res-4."""
    pos = box_lattice((grid_res,) * 3, (box,) * 3, spacing)
    config = SimConfig(
        grid_res=(grid_res,) * 3,
        num_particles=pos.shape[0],
        substeps=5,
        clamp_lo=1.0,
        clamp_hi_offset=2.0,
        wall_min=3.0,
        wall_max_offset=4.0,
        wall_stiffness=1.0,
        bin_capacity=16,
    )
    fluid = FluidParams.create(dim=3, eos_stiffness=10.0, eos_power=4.0)
    return Scene("fluid_3d_cpu", config, fluid, make_state(pos, device))


def fluid_3d_fixed_point(grid_res: int = 32, box: float = 16.0, spacing: float = 1.0,
                         device: torch.device | str = "cuda") -> Scene:
    """S4, the 3D fixed-point atomics variant
    (MLSMPM3DFluidMultithreadNew.cs:26-64): 32^3 grid, 16^3 box at spacing
    1.0 -> 4,096 particles, int32 grid with multiplier 1e7, K=8."""
    pos = box_lattice((grid_res,) * 3, (box,) * 3, spacing)
    config = SimConfig(
        grid_res=(grid_res,) * 3,
        num_particles=pos.shape[0],
        substeps=5,
        clamp_lo=1.0,
        clamp_hi_offset=2.0,
        wall_min=3.0,
        wall_max_offset=4.0,
        wall_stiffness=1.0,
        fixed_point=True,
        bin_capacity=8,
    )
    fluid = FluidParams.create(dim=3, eos_stiffness=10.0, eos_power=4.0)
    return Scene("fluid_3d_fixed_point", config, fluid, make_state(pos, device))


def fluid_3d(
    grid_res: int = 64,
    box: float = 32.0,
    spacing: float = 0.6,
    center: tuple[float, float, float] | None = None,
    device: torch.device | str = "cuda",
) -> Scene:
    """S5, the flagship 3D GPU variant
    (MLSMPM3DFluidMultithreadGPU.cs:43-98,654-671): 64^3 grid, 32^3 box at
    spacing 0.6 -> 157,464 particles, 2 substeps/frame, eos_stiffness 1,
    eos_power 7, clamp [2, res-2], wall_min 3."""
    pos = box_lattice((grid_res,) * 3, (box,) * 3, spacing, center=center)
    config = SimConfig(
        grid_res=(grid_res,) * 3,
        num_particles=pos.shape[0],
        substeps=2,
        clamp_lo=2.0,
        clamp_hi_offset=2.0,
        wall_min=3.0,
        wall_max_offset=3.0,
        wall_stiffness=1.0,
        bin_capacity=16,
    )
    fluid = FluidParams.create(dim=3, eos_stiffness=1.0, eos_power=7.0)
    return Scene("fluid_3d", config, fluid, make_state(pos, device))


def _corners() -> np.ndarray:
    corners = np.stack(np.meshgrid(*([[0.25, 0.75]] * 3), indexing="ij"), -1)
    return corners.reshape(8, 3)


def benchmark_scene(
    n_target: int,
    grid_res: tuple[int, int, int] | None = None,
    bin_capacity: int = 8,
    device: torch.device | str = "cuda",
) -> Scene:
    """Benchmark pool with uniform per-cell packing: every fluid cell holds
    its hydrostatic-equilibrium particle count on a per-cell sub-lattice, so
    the maximum occupancy equals the mean and K=8 suffices. A stiff EOS
    (eos_stiffness 12) keeps bottom compression under 1.36x; the per-row
    counts follow m(xi) = m0 * (1 + g*rho0*(H - xi)/k)^(1/gamma), so the pool
    starts at EOS equilibrium. bf16 vel/C storage, eos_power_static 7."""
    m0 = 6  # rest particles/cell (= rest_density with unit mass)
    g, k_eos, gamma = 0.3, 12.0, 7.0
    rho0 = float(m0)
    if grid_res is None:
        side = round((n_target / m0) ** (1.0 / 3.0))
        rx = rz = -((side + 6) // -16) * 16
    else:
        rx, rz = grid_res[0], grid_res[2]
    wx = rx - 6  # fluid columns occupy cells [3, r-3) per horizontal axis
    wz = rz - 6
    ncols = wx * wz
    height_rest = n_target / (m0 * ncols)

    rows = []
    placed = 0
    xi = 0.0
    while placed < n_target:
        s = (1.0 + g * rho0 * max(height_rest - xi, 0.0) / k_eos) ** (1.0 / gamma)
        m_r = int(np.clip(round(m0 * s), 1, 8))
        take = min(m_r * ncols, n_target - placed)
        rows.append((m_r, take))
        placed += take
        xi += m_r / m0
    n_rows = len(rows)

    if grid_res is None:
        ry = -((n_rows + 11) // -8) * 8  # floor 3 + ~8 cells slosh headroom
        grid_res = (rx, ry, rz)
    else:
        assert n_rows + 6 <= grid_res[1], (
            f"benchmark pool needs ~{n_rows + 6} y-cells "
            f"(footprint {wx}x{wz}), grid_res[1]={grid_res[1]} is too short"
        )
    config = SimConfig(
        grid_res=grid_res,
        num_particles=n_target,
        substeps=2,
        clamp_lo=2.0,
        clamp_hi_offset=2.0,
        wall_min=3.0,
        wall_max_offset=3.0,
        wall_stiffness=1.0,
        bin_capacity=bin_capacity,
        storage_dtype="bfloat16",
        eos_power_static=7.0,
    )
    fluid = FluidParams.create(
        dim=3, dt=0.05, rest_density=rho0, eos_stiffness=k_eos, eos_power=gamma
    )

    corners = _corners()
    cxs = 3.0 + np.arange(wx, dtype=np.float32)
    czs = 3.0 + np.arange(wz, dtype=np.float32)
    gx, gz = np.meshgrid(cxs, czs, indexing="ij")
    gx, gz = gx.reshape(-1), gz.reshape(-1)
    rng = np.random.default_rng(12345)
    parts = []
    for r, (m_r, take) in enumerate(rows):
        nfull = take // m_r
        rot = (np.arange(ncols) * 3 + r * 5) % 8
        base = np.stack([gx, np.full_like(gx, 3.0 + r), gz], -1)
        sub = corners[(rot[:, None] + np.arange(m_r)[None, :]) % 8]
        pts = base[:, None, :] + sub
        pts = pts[:nfull].reshape(-1, 3)
        rem = take - nfull * m_r
        if rem:
            pts = np.concatenate([pts, (base[nfull] + sub[nfull])[:rem]])
        parts.append(pts)
    pos = np.concatenate(parts, axis=0).astype(np.float32)
    pos += rng.uniform(-0.04, 0.04, pos.shape).astype(np.float32)
    assert pos.shape[0] == config.num_particles
    return Scene(f"bench_{n_target}", config, fluid, make_state(pos, device))


def benchmark_dam_break(n_target: int = 1_000_000,
                        device: torch.device | str = "cuda") -> Scene:
    """Dynamic churn benchmark: a tall dam column filling the left ~60% of x
    collapses across the domain. Uniform m0 = 5 particles/cell on the same
    per-cell sub-lattice as benchmark_scene; K = 8 leaves 3 slots of
    headroom at the impact front, and a stiff EOS (k=30) keeps the settled
    end state below 8 per cell."""
    m0 = 5
    rx, rz = 64, 64
    wx = 37  # dam occupies x cells [3, 40)
    wz = rz - 6
    ncols = wx * wz
    n_rows = -(-n_target // (m0 * ncols))
    ry = -((n_rows + 3 + 8) // -8) * 8
    config = SimConfig(
        grid_res=(rx, ry, rz),
        num_particles=n_target,
        substeps=2,
        clamp_lo=2.0,
        clamp_hi_offset=2.0,
        wall_min=3.0,
        wall_max_offset=3.0,
        wall_stiffness=1.0,
        bin_capacity=8,
        storage_dtype="bfloat16",
        eos_power_static=7.0,
    )
    fluid = FluidParams.create(
        dim=3, dt=0.03, rest_density=float(m0), eos_stiffness=30.0,
        eos_power=7.0,
    )
    corners = _corners()
    cxs = 3.0 + np.arange(wx, dtype=np.float32)
    czs = 3.0 + np.arange(wz, dtype=np.float32)
    gx, gz = np.meshgrid(cxs, czs, indexing="ij")
    gx, gz = gx.reshape(-1), gz.reshape(-1)
    rng = np.random.default_rng(4242)
    parts = []
    placed = 0
    for r in range(n_rows):
        take = min(m0 * ncols, n_target - placed)
        nfull = take // m0
        rot = (np.arange(ncols) * 3 + r * 5) % 8
        base = np.stack([gx, np.full_like(gx, 3.0 + r), gz], -1)
        sub = corners[(rot[:, None] + np.arange(m0)[None, :]) % 8]
        pts = (base[:, None, :] + sub)[:nfull].reshape(-1, 3)
        rem = take - nfull * m0
        if rem:
            pts = np.concatenate([pts, (base[nfull] + sub[nfull])[:rem]])
        parts.append(pts)
        placed += take
        if placed >= n_target:
            break
    pos = np.concatenate(parts, axis=0).astype(np.float32)
    pos += rng.uniform(-0.04, 0.04, pos.shape).astype(np.float32)
    assert pos.shape[0] == n_target
    return Scene(f"dam_{n_target}", config, fluid, make_state(pos, device))


def _bench3d(n_target: int = 1_000_000, **kw) -> Scene:
    return benchmark_scene(n_target, **kw)


# The scenes of mpm_tpu.models.scenes.SCENES.
SCENES = {
    "dam_break_2d": dam_break_2d,
    "fluid_2d_friction": fluid_2d_friction,
    "bench2d": benchmark_scene_2d,
    "fluid_3d_cpu": fluid_3d_cpu,
    "fluid_3d_fixed_point": fluid_3d_fixed_point,
    "fluid_3d": fluid_3d,
    "bench3d": _bench3d,
    "bench3d_dam": benchmark_dam_break,
}


def get_scene(name: str, device: torch.device | str = "cuda", **kw) -> Scene:
    return SCENES[name](device=device, **kw)
