"""Simulation state (PyTorch port of ``mpm_tpu.core.state``).

Structure of arrays with the particle index last, as in the JAX package:
pos [D, N], vel [D, N], C [D, D, N], mass [N], ids [N]. The grid is flat
row-major: mom [D, num_cells], mass [num_cells].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .params import SimConfig


class Grid(NamedTuple):
    """Dense background grid, flattened row-major. `mom` holds momentum during
    P2G and velocity after the grid update (update_grid.glsl:44-56)."""

    mom: torch.Tensor  # [D, num_cells] float, or int32 in fixed-point mode
    mass: torch.Tensor  # [num_cells]


@dataclasses.dataclass
class SimState:
    """Linear particle state; `ids` carries the emission index."""

    pos: torch.Tensor  # [D, N]
    vel: torch.Tensor  # [D, N]
    C: torch.Tensor  # [D, D, N]
    mass: torch.Tensor  # [N]
    ids: torch.Tensor  # [N] int32

    @property
    def num_particles(self) -> int:
        return self.pos.shape[-1]

    @property
    def dim(self) -> int:
        return self.pos.shape[0]

    def permute(self, perm: torch.Tensor) -> "SimState":
        """The same particles in the order `perm`; ids travel with them."""
        return SimState(pos=self.pos[..., perm], vel=self.vel[..., perm],
                        C=self.C[..., perm], mass=self.mass[perm], ids=self.ids[perm])

    def by_id(self) -> "SimState":
        """A copy in emission order (ids ascending)."""
        return self.permute(torch.argsort(self.ids, stable=True))

    def pos_rows(self) -> torch.Tensor:
        """Positions as [N, D] (host and analysis convenience)."""
        return self.pos.T


def zero_grid(config: SimConfig, device: torch.device | str) -> Grid:
    """The `clear_grid` pass (clear_grid.glsl:20-29): fresh zeros."""
    dtype = torch.int32 if config.fixed_point else config.dtype
    return Grid(
        mom=torch.zeros((config.dim, config.num_cells), dtype=dtype, device=device),
        mass=torch.zeros((config.num_cells,), dtype=dtype, device=device),
    )


def make_state(pos_rows, device: torch.device | str, vel=None, C=None, mass=None,
               dtype: torch.dtype = torch.float32) -> SimState:
    """Build a state from [N, D] row-major positions (emitter output) on
    `device`; a CUDA device with no card visible raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass device='cpu' to build the "
                           "state on the CPU")
    pos = torch.as_tensor(pos_rows, dtype=dtype).T.contiguous().to(device)
    d, n = pos.shape
    return SimState(
        pos=pos,
        vel=(torch.zeros((d, n), dtype=dtype, device=device) if vel is None
             else torch.as_tensor(vel, dtype=dtype).T.contiguous().to(device)),
        C=(torch.zeros((d, d, n), dtype=dtype, device=device) if C is None
           else torch.as_tensor(C, dtype=dtype).to(device)),
        mass=(torch.ones((n,), dtype=dtype, device=device) if mass is None
              else torch.as_tensor(mass, dtype=dtype).to(device)),
        ids=torch.arange(n, dtype=torch.int32, device=device),
    )
