"""The per-cell splat extraction shared by kernel X (render/extract_kernel)
and kernel F's splat emission (ops/cuda/g2p_migrate): the 16 render
scalars, their host form for the C entry points, and the plain PyTorch
version of csrc/extract_cells.cuh.

Per cell, the minimum-depth valid slot wins (mass > 0, beyond the near
plane; the first in slot order on a tie). Output rows: (pixel x, pixel y,
linear depth, |vel|, valid count); depth CELL_BG marks an empty cell.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

CELL_BG = 1.0e9  # "no splat from this cell" depth sentinel


def render_scals_for(view, cam) -> torch.Tensor:
    """[16] float32 CPU tensor: the world->view rows (3x4, row-major), then
    focal_px, width/2, height/2 and near, the layout of the JAX package's
    fused.render_scals_for and of csrc/extract_cells.cuh RenderScals."""
    v = (view.to("cpu", torch.float32) if isinstance(view, torch.Tensor)
         else torch.from_numpy(np.array(view, np.float32)))
    tail = torch.tensor([cam.focal_px, cam.width / 2.0, cam.height / 2.0, cam.near],
                        dtype=torch.float32)
    return torch.cat([v[:3, :4].reshape(-1), tail])


def scals_arg(scals: torch.Tensor):
    """The 16 render scalars as a host float array for the C entry points."""
    return (ctypes.c_float * 16)(*scals.tolist())


def cell_splats_plain(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
                      scals: torch.Tensor) -> torch.Tensor:
    """The plain version from bucket arrays pos [3, K, C], vel [3, K, C],
    mass [K, C] and the 16 render scalars: [5, C] float32. It rounds as
    csrc/extract_cells.cuh does, operation for operation."""
    s = [float(x) for x in scals.tolist()]  # float32 values, exact as floats
    p = pos.float()
    v = vel.float()
    vp = [s[4 * r] * p[0] + s[4 * r + 1] * p[1] + s[4 * r + 2] * p[2] + s[4 * r + 3]
          for r in range(3)]
    depth = -vp[2]
    safe = torch.where(depth > 1e-6, depth, 1e-6)
    px = s[13] + s[12] * vp[0] / safe
    py = s[14] - s[12] * vp[1] / safe
    vmag = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    valid = (mass > 0) & (depth > s[15])
    dmask = torch.where(valid, depth, CELL_BG)
    dmin = torch.amin(dmask, dim=0)
    zero = torch.zeros_like(dmin)
    sel = [zero, zero, zero]
    found = torch.zeros_like(dmin, dtype=torch.bool)
    for k in range(mass.shape[0]):
        m = valid[k] & (dmask[k] == dmin) & ~found
        sel = [torch.where(m, x[k], y) for x, y in zip((px, py, vmag), sel)]
        found = found | m
    return torch.stack([sel[0], sel[1], torch.where(found, dmin, CELL_BG), sel[2],
                        valid.sum(dim=0, dtype=torch.float32)])
