"""Particle <-> grid transfer geometry and per-tap contributions (port of
``mpm_tpu.ops.transfer``).

Every pass starts from the same quantities per particle: the base cell, the
three quadratic B-spline weights per axis, and for each of the 3^D taps the
product weight, the tap's cell and the cell-centre distance (p2g_1.glsl:44-70,
MLSMPM2DFluid.cs:203-219). Layout [D, N]; per-tap quantities are computed
inside the tap loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.params import SimConfig
from . import bspline


class TransferGeometry(NamedTuple):
    base: torch.Tensor  # [D, N] int32 base cell (floor(pos), clipped to the grid)
    d: torch.Tensor  # [D, N] offset from the base cell's centre
    flat_base: torch.Tensor  # [N] int32 flat base cell id


def geometry(pos: torch.Tensor, config: SimConfig) -> TransferGeometry:
    """The base cell clipped to [1, res - 2] per axis (a no-op under the
    reference's position clamps), its offset and flat id."""
    base_raw = bspline.base_cell(pos)
    base = torch.stack([torch.clamp(base_raw[a], 1, config.grid_res[a] - 2)
                        for a in range(config.dim)])
    d = pos - base.to(pos.dtype) - 0.5
    flat = base[0]
    for a in range(1, config.dim):
        flat = flat * config.grid_res[a] + base[a]
    return TransferGeometry(base=base, d=d, flat_base=flat)


def flat_tap_offsets(config: SimConfig) -> list[int]:
    """The constant flat-index offset of each tap on the row-major grid."""
    strides = [1] * config.dim
    for a in range(config.dim - 2, -1, -1):
        strides[a] = strides[a + 1] * config.grid_res[a + 1]
    return [sum((t[a] - 1) * strides[a] for a in range(config.dim))
            for t in bspline.taps(config.dim)]


def p2g1_tap_contribs(state, d: torch.Tensor, tap: tuple[int, ...]):
    """Per-tap mass and APIC momentum contributions m*w, m*w*(v + C dist)
    (p2g_1.glsl:56-93): ([N], [D, N])."""
    w = bspline.tap_weight(d, tap)
    dist = bspline.tap_dist(d, tap)
    mass_c = w * state.mass
    Cd = bspline.matvec(state.C, dist)
    mom_c = mass_c * (state.vel + Cd)
    return mass_c, mom_c


def p2g2_tap_contribs(eq16: torch.Tensor, d: torch.Tensor, tap: tuple[int, ...]) -> torch.Tensor:
    """Per-tap force momentum w * (eq16 @ dist) (p2g_2.glsl:111-153):
    eq16 [D, D, N] -> [D, N]."""
    w = bspline.tap_weight(d, tap)
    dist = bspline.tap_dist(d, tap)
    return w * bspline.matvec(eq16, dist)
