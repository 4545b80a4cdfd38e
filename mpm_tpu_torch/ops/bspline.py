"""Quadratic B-spline interpolation (port of ``mpm_tpu.ops.bspline``):

    d  = pos - floor(pos) - 0.5
    w0 = 0.5 * (0.5 - d)^2
    w1 = 0.75 - d^2
    w2 = 0.5 * (0.5 + d)^2

(p2g_1.glsl:47-52). dx is 1 in cell units; the 4/dx^2 factor is folded into
C = 4B and the force term. Layout: [D, ...] with the particle axes last.
Every product is written out in the JAX package's order, so both round alike.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import torch


def base_cell(pos: torch.Tensor) -> torch.Tensor:
    """Integer base cell (floor) per particle: [D, N] -> [D, N] int32."""
    return torch.floor(pos).to(torch.int32)


def cell_diff(pos: torch.Tensor) -> torch.Tensor:
    """Fractional offset from the base cell centre: frac(pos) - 0.5."""
    return pos - torch.floor(pos) - 0.5


@lru_cache(maxsize=None)
def taps(dim: int) -> tuple[tuple[int, ...], ...]:
    """The 3^D tap indices (0, 1, 2 per axis; node = base + tap - 1), in the
    reference's nested gx/gy/gz loop order (p2g_1.glsl:56-93)."""
    return tuple(itertools.product((0, 1, 2), repeat=dim))


def axis_weight(tap_a: int, d_a: torch.Tensor) -> torch.Tensor:
    """Weight of tap index tap_a in {0,1,2} on one axis."""
    if tap_a == 0:
        t = 0.5 - d_a
        return 0.5 * (t * t)
    if tap_a == 1:
        return 0.75 - d_a * d_a
    t = 0.5 + d_a
    return 0.5 * (t * t)


def tap_weight(d: torch.Tensor, tap: tuple[int, ...]) -> torch.Tensor:
    """Separable product weight for one tap. d: [D, ...] -> [...]."""
    w = axis_weight(tap[0], d[0])
    for a in range(1, len(tap)):
        w = w * axis_weight(tap[a], d[a])
    return w


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [D, D, ...] @ v [D, ...] -> [D, ...], unrolled in a fixed order."""
    dim = M.shape[0]
    rows = []
    for i in range(dim):
        acc = M[i, 0] * v[0]
        for j in range(1, dim):
            acc = acc + M[i, j] * v[j]
        rows.append(acc)
    return torch.stack(rows)


def matvec_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M^T @ v, unrolled like matvec."""
    dim = M.shape[0]
    rows = []
    for i in range(dim):
        acc = M[0, i] * v[0]
        for j in range(1, dim):
            acc = acc + M[j, i] * v[j]
        rows.append(acc)
    return torch.stack(rows)


def tap_dist(d: torch.Tensor, tap: tuple[int, ...]) -> torch.Tensor:
    """Node minus particle position for one tap: (tap - 1) - d
    (the reference's `cell_dist = (cell_x - p.pos) + 0.5`, p2g_1.glsl:70)."""
    off = torch.tensor([float(t - 1) for t in tap], dtype=d.dtype, device=d.device)
    return off.reshape(-1, *([1] * (d.ndim - 1))) - d
