"""Particle emitters (numpy; identical to ``mpm_tpu.models.emitters``).

The reference seeds particles on a regular lattice inside an axis-aligned box
centered on the grid (MLSMPM3DFluidMultithreadGPU.cs:654-671). The lattice
loop `for (i = c - b/2; i < c + b/2; i += spacing)` is reproduced exactly so
particle counts match (32^3 box at spacing 0.6 -> 54^3 = 157,464).
"""

from __future__ import annotations

import numpy as np


def _axis_points(center: float, extent: float, spacing: float) -> np.ndarray:
    # matches the C# loop bound semantics: i from c-e/2 while i < c+e/2
    start = center - extent / 2.0
    stop = center + extent / 2.0
    n = int(np.ceil((stop - start) / spacing - 1e-9))
    return start + spacing * np.arange(n)


def box_lattice(
    grid_res: tuple[int, ...],
    box: tuple[float, ...],
    spacing: float,
    center: tuple[float, ...] | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Lattice of particle positions filling `box` centered at `center`
    (default: grid center). Returns [N, D]."""
    dim = len(grid_res)
    if center is None:
        center = tuple(r / 2.0 for r in grid_res)
    axes = [_axis_points(center[a], box[a], spacing) for a in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    return pts.astype(dtype)
