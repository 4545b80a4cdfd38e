"""Simulation parameter containers (PyTorch port of ``mpm_tpu.core.params``).

- :class:`SimConfig` is static and hashable. It fixes array shapes and the
  code path (grid size, slots per cell, storage type, EOS exponent).
- :class:`FluidParams` holds the runtime-tunable fluid scalars as float32
  CPU tensors, so changing one never changes a code path. Arithmetic with
  them rounds exactly like the JAX package's float32 scalars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

# Boundary-condition flavors (the reference's three commented variants,
# MLSMPM2DFluidMultithread.cs:354-368).
BC_SLIP = "slip"
BC_STICK = "stick"
BC_FRICTION = "friction"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration. Field names, defaults and meaning
    follow ``mpm_tpu.core.params.SimConfig`` one for one."""

    grid_res: tuple[int, ...] = (64, 64, 64)
    num_particles: int = 0
    substeps: int = 2

    # True physical domain when the arrays cover only a y-window of it (the
    # air-window engine, ops/window.py). Every physics POSITION (particle
    # clamps, wall springs, grid BC bands) uses `dres`; array extents and
    # strides use `grid_res`. None means grid_res is the domain.
    domain_res: tuple[int, ...] | None = None

    # Grid BC: the normal velocity component is zeroed for index < bc_band_lo
    # and index > res - 1 - bc_band_hi (update_grid.glsl:60-66).
    bc: str = BC_SLIP
    friction: float = 0.5
    bc_band_lo: int = 2
    bc_band_hi: int = 2

    # Particle position clamp after advection: [clamp_lo, res - clamp_hi_offset].
    clamp_lo: float = 2.0
    clamp_hi_offset: float = 2.0

    # Predictive wall spring (g2p.glsl:131-140).
    wall_min: float = 3.0
    wall_max_offset: float = 3.0
    wall_stiffness: float = 1.0

    # 2D serial variant strain (diagonal left unscaled, MLSMPM2DFluid.cs:276-281).
    legacy_strain: bool = False

    # int32 fixed-point grid accumulation (p2g_1.glsl:34-37).
    fixed_point: bool = False
    fixed_point_mult: float = 1.0e7

    # K: particle slots per bucket cell.
    bin_capacity: int = 16

    dtype: torch.dtype = torch.float32

    # Storage type of the bucket-state vel and C arrays ("float32" or
    # "bfloat16"). All arithmetic is float32; values round once per substep,
    # at the store.
    storage_dtype: str = "float32"

    # Static EOS exponent (0.0 = use FluidParams.eos_power at run time).
    # Integer values unroll into multiplies (ops/stress.pow_static).
    eos_power_static: float = 0.0

    @property
    def dres(self) -> tuple[int, ...]:
        """True domain resolution: domain_res if windowed, else grid_res."""
        return self.domain_res if self.domain_res is not None else self.grid_res

    @property
    def vc_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.storage_dtype == "bfloat16" else torch.float32

    @property
    def dim(self) -> int:
        return len(self.grid_res)

    @property
    def num_cells(self) -> int:
        return math.prod(self.grid_res)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class FluidParams:
    """Runtime-tunable fluid parameters: float32 tensors on the CPU (0-d,
    gravity [D]). Defaults are the reference's (MLSMPM2DFluid.cs:30-40,
    MLSMPM3DFluidMultithreadGPU.cs:57-84)."""

    dt: torch.Tensor
    gravity: torch.Tensor
    rest_density: torch.Tensor
    dynamic_viscosity: torch.Tensor
    eos_stiffness: torch.Tensor
    eos_power: torch.Tensor
    pressure_floor: torch.Tensor

    @staticmethod
    def create(
        dim: int,
        dt: float = 0.2,
        gravity: float | Sequence[float] | None = None,
        rest_density: float = 4.0,
        dynamic_viscosity: float = 0.1,
        eos_stiffness: float = 10.0,
        eos_power: float = 7.0,
        pressure_floor: float = -0.1,
    ) -> "FluidParams":
        if gravity is None:
            # 2D: +0.3 on y (screen down); 3D: -0.3 on y.
            gravity = (0.0, 0.3) if dim == 2 else (0.0, -0.3, 0.0)
        elif isinstance(gravity, (int, float)):
            g = [0.0] * dim
            g[1] = float(gravity)
            gravity = tuple(g)
        return FluidParams(
            dt=_f32(dt),
            gravity=_f32(gravity),
            rest_density=_f32(rest_density),
            dynamic_viscosity=_f32(dynamic_viscosity),
            eos_stiffness=_f32(eos_stiffness),
            eos_power=_f32(eos_power),
            pressure_floor=_f32(pressure_floor),
        )
