"""Radial force emitters, the reference's mouse/sphere (port of
``mpm_tpu.ops.interact``):

- 3D sphere collider (g2p.glsl:122-129): inside the radius,
  force = normalize(d) * strength.
- 2D mouse (MLSMPM2DFluid.cs:382-406): force = normalize(d) *
  (radius / |d|) * strength.

Fields are float32 CPU tensors, like FluidParams: moving the sphere changes
no code path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from .fmath import sqrt_rn


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class Interaction:
    """One radial force emitter. `active` gates it (0.0 = off)."""

    center: torch.Tensor  # [D]
    radius: torch.Tensor
    strength: torch.Tensor
    # 0.0 -> constant radial push (3D sphere); 1.0 -> radius/|d| falloff (2D mouse)
    inv_falloff: torch.Tensor
    active: torch.Tensor

    @staticmethod
    def sphere(center, radius=15.0, strength=1.0, active=1.0) -> "Interaction":
        """The flagship's sphere collider (g2p.glsl:122-129)."""
        return Interaction(center=_f32(center), radius=_f32(radius),
                           strength=_f32(strength), inv_falloff=_f32(0.0),
                           active=_f32(active))

    @staticmethod
    def mouse(center, radius=10.0, strength=0.1, active=1.0) -> "Interaction":
        """The 2D mouse repulsion (MLSMPM2DFluid.cs:382-406)."""
        return Interaction(center=_f32(center), radius=_f32(radius),
                           strength=_f32(strength), inv_falloff=_f32(1.0),
                           active=_f32(active))

    def values(self) -> list[float]:
        """[center (D values), radius, strength, inv_falloff, active] as
        floats (the layout the CUDA tails read)."""
        return [float(v) for v in self.center.tolist()] + [
            float(self.radius), float(self.strength), float(self.inv_falloff),
            float(self.active)]


def interaction_rows(interactions: Sequence[Interaction], dim: int,
                     device) -> torch.Tensor | None:
    """The interactions as one float32 array [n, dim + 4] on `device`, each
    row `values()`, in list order (the CUDA tails read it by pointer, any
    number of rows); None for none. Raises for a centre of another
    dimension. Read-only: one array is kept for each set of values."""
    if not interactions:
        return None
    rows = tuple(tuple(it.values()) for it in interactions)
    if any(len(r) != dim + 4 for r in rows):
        raise ValueError(f"the {dim}D tails take {dim}D interactions (a centre of {dim} values)")
    return _rows_on(rows, torch.device(device))


@functools.lru_cache(maxsize=32)
def _rows_on(rows: tuple, device: torch.device) -> torch.Tensor:
    """The rows on `device`, made once for each set of values (a moving
    sphere makes a new one each time it moves). To a card from pinned
    memory, so the copy is queued on the stream and the host does not wait
    for the card."""
    host = torch.tensor(rows, dtype=torch.float32)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def apply_interactions(pos: torch.Tensor, vel: torch.Tensor,
                       interactions: Sequence[Interaction]) -> torch.Tensor:
    """Add interaction impulses to `vel`. pos/vel: [D, ...]."""
    for it in interactions:
        center = it.center.to(pos.device).reshape(-1, *([1] * (pos.ndim - 1)))
        d = pos - center
        r2 = d[0] * d[0]
        for a in range(1, d.shape[0]):
            r2 = r2 + d[a] * d[a]
        inside = (r2 < it.radius * it.radius) & bool(it.active > 0)
        norm = sqrt_rn(r2)
        safe_norm = torch.where(norm > 0, norm, 1.0)
        dirn = d / safe_norm
        falloff = 1.0 + it.inv_falloff * (it.radius / safe_norm - 1.0)
        force = dirn * (it.strength * falloff)
        # NaN guard (MLSMPM2DFluid.cs:394): a particle exactly at the center
        # gets no force
        ok = inside & (norm > 0) & torch.all(torch.isfinite(force), dim=0)
        vel = vel + torch.where(ok, force, 0.0)
    return vel
