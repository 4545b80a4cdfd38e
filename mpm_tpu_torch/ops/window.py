"""Air-window engine (port of ``mpm_tpu.ops.window``): run the step on the
occupied y-range of the domain.

Every bucket slot costs work whether it holds fluid or air, so the arrays
cover a y-window [0, wy) of the domain while the physics stays at the true
domain:

- The windowed SimConfig sets grid_res=(nx, wy, nz) and domain_res to the
  true grid. Every physics position (particle clamps, wall springs, grid BC
  bands) uses domain_res, so cells above the window are inert and the
  windowed trajectory equals the full-grid one.
- The invariant max occupied y <= wy - 4 is enforced inside the step: the
  window's top planes form a ceiling band that rejects incoming y-movers
  like a full bucket (bucketed.reject_overflow and the kernel F reject
  launch), counted in BucketState.ceiling. That counter is the exactness
  certificate: ceiling == 0 across a run proves no particle touched the
  window edge.
- Growth policy: after every chunk YWindow reads (max occupied y,
  ceiling) back with one small device-to-host copy, keeps `headroom`
  planes above the surface, grows at once on a ceiling hit (counted in
  `interference`), and shrinks with 2 * quantum hysteresis.
- Over a SlabMesh (parallel/domain.py) the chunks run the sharded step.
  The slabs split only x, so the window is global: the max y is taken over
  the slabs, the ceiling counter is the slabs' total, and a resize acts on
  every slab. The resize schedule is the unsharded window's.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..core.params import FluidParams, SimConfig
from ..core.state import SimState
from ..utils.timing import span, spanned
from . import bucketed
from .interact import Interaction
from .step import make_frame_fn


def window_config(config: SimConfig, wy: int) -> SimConfig:
    """The SimConfig of a y-window [0, wy) of `config`'s domain; wy >= ny
    returns `config` itself."""
    if config.domain_res is not None:
        raise ValueError("window_config expects a non-windowed config")
    nx, ny, nz = config.grid_res
    if wy >= ny:
        return config
    return config.replace(grid_res=(nx, wy, nz), domain_res=config.grid_res)


def _poll_vals(state: bucketed.BucketState, wy: int, nz: int) -> torch.Tensor:
    """[2] int32 on the state's device: (max occupied y, ceiling counter)."""
    occ_y = torch.any((state.mass > 0).reshape(-1, wy, nz), dim=2)
    occ_y = torch.any(occ_y, dim=0)  # [wy]
    ys = torch.arange(wy, dtype=torch.int32, device=state.device)
    maxy = torch.max(torch.where(occ_y, ys, -1))
    return torch.stack([maxy, state.ceiling.to(torch.int32)])


def _resize(state: bucketed.BucketState, old_cfg: SimConfig,
            new_cfg: SimConfig, x0: int = 0) -> bucketed.BucketState:
    """Pad (grow) or slice (shrink) the bucket arrays along y. Empty slots in
    the new region are parked at their own cell centers (global: x0 is the
    global plane of a slab's plane 0)."""
    nx, wy_o, nz = old_cfg.grid_res
    wy_n = new_cfg.grid_res[1]

    def r(x, fill):
        lead = x.shape[:-1]
        x = x.reshape(*lead, nx, wy_o, nz)
        if wy_n > wy_o:
            x = F.pad(x, (0, 0, 0, wy_n - wy_o), value=fill)
        else:
            x = x[..., :wy_n, :]
        return x.reshape(*lead, nx * wy_n * nz).contiguous()

    mass = r(state.mass, 0.0)
    occ = mass > 0
    center = bucketed.cell_coords(new_cfg, state.device, state.pos.dtype, x0) + 0.5
    zero = torch.zeros((), dtype=state.vel.dtype, device=state.device)
    return state.replace(
        pos=torch.where(occ[None], r(state.pos, 0.0), center[:, None, :]).contiguous(),
        vel=torch.where(occ[None], r(state.vel, 0.0), zero).contiguous(),
        C=torch.where(occ[None, None], r(state.C, 0.0), zero).contiguous(),
        mass=mass,
        ids=torch.where(occ, r(state.ids, -1), -1).contiguous(),
    )


class YWindow:
    """Windowed stepper:

        win = YWindow(config, mode="cuda", substeps=chunk)
        state = win.init(sim_state)          # SimState -> windowed BucketState
        state = win.step(state, fluid, ())   # one chunk; may resize

    `win.config` is the current windowed SimConfig, `win.wy` the window
    height, `win.interference` the total ceiling hits observed (0 means the
    windowed run equals the full-grid run). One YWindow per simulation.
    With `mesh` (a parallel.domain.SlabMesh) the state is a ShardedState
    and the chunks run the sharded step.
    """

    def __init__(self, config: SimConfig, mode: str = "auto",
                 substeps: int | None = None, quantum: int = 8,
                 headroom: int | None = None, mesh=None):
        # headroom: planes kept above the last observed surface. The default
        # substeps + 5 covers a chunk's worst-case rise (1 cell per substep)
        # plus the ceiling band, so the band is never reached. Tighter values
        # (>= 4: the 3-plane band + 1 legal row) stay safe: the band rejects
        # and counts any mover that reaches it, and the window grows.
        if config.dim != 3:
            raise ValueError("YWindow supports 3D configs")
        self.true_config = config
        self.mode = mode
        self.mesh = mesh
        self.S = substeps if substeps is not None else config.substeps
        self.headroom = headroom if headroom is not None else self.S + 5
        if self.headroom < 4:
            raise ValueError("headroom must cover the 3-plane ceiling band "
                             "plus one legal row (>= 4)")
        self.q = quantum
        self.wy = config.grid_res[1]
        self.resizes = 0
        self.interference = 0  # observed ceiling hits (0 = certified exact)
        self._confirmed = -1  # last observed max occupied y
        self._ceil_seen = 0  # last observed ceiling counter
        self._frames: dict[int, Callable] = {}

    @property
    def config(self) -> SimConfig:
        return window_config(self.true_config, self.wy)

    def _frame_fn(self, wy: int) -> Callable:
        if wy not in self._frames:
            wcfg = window_config(self.true_config, wy)
            if self.mesh is not None:
                from ..parallel.domain import make_sharded_bucket_step

                self._frames[wy] = make_sharded_bucket_step(wcfg, self.mesh, self.S,
                                                            mode=self.mode)
            else:
                self._frames[wy] = make_frame_fn(wcfg, mode=self.mode, substeps=self.S)
        return self._frames[wy]

    def _target_wy(self, maxy: int) -> int:
        ny = self.true_config.grid_res[1]
        wy = max(self.q, math.ceil((maxy + self.headroom) / self.q) * self.q)
        return min(ny, wy)

    def _observe(self, state) -> int:
        """Read (max y, ceiling) back; returns the new ceiling hits."""
        nz = self.true_config.grid_res[2]
        with span("mpm.window.poll"):
            if self.mesh is None:
                maxy, ceil = _poll_vals(state, self.wy, nz).tolist()
            else:  # max y over the slabs, gathered on the first slab's device
                # for one read; the counter is already the total on every slab
                dev = state.slabs[0].device
                vals = torch.stack([_poll_vals(s, self.wy, nz).to(dev) for s in state.slabs])
                maxy, ceil = torch.stack([vals[:, 0].max(), vals[0, 1]]).tolist()
        self._confirmed = maxy
        hits = ceil - self._ceil_seen
        self._ceil_seen = ceil
        if hits > 0:
            self.interference += hits
        return max(hits, 0)

    def init(self, state: SimState):
        maxy = int(torch.floor(state.pos[1]).max())
        self._confirmed = maxy
        self._ceil_seen = 0
        self.wy = self._target_wy(maxy)
        b = bucketed.from_simstate(state, self.config)
        if self.mesh is not None:
            from ..parallel.domain import shard_bucket_state

            b = shard_bucket_state(b, self.config, self.mesh)
        return b

    @spanned("mpm.window.resize")
    def _resize_state(self, state, wy_new: int):
        old = window_config(self.true_config, self.wy)
        new = window_config(self.true_config, wy_new)
        if self.mesh is None:
            return _resize(state, old, new)
        from ..parallel.domain import ShardedState, slab_planes

        loc = slab_planes(old, self.mesh.n)
        return ShardedState([
            _resize(s, bucketed.slab_config(old, loc), bucketed.slab_config(new, loc), a * loc)
            for a, s in enumerate(state.slabs)])

    def _state_wy(self, state) -> int:
        """The window height of a state's arrays."""
        nx, _, nz = self.true_config.grid_res
        if self.mesh is None:
            return state.mass.shape[-1] // (nx * nz)
        return state.slabs[0].mass.shape[-1] // (nx // self.mesh.n * nz)

    @spanned("mpm.window.step")
    def step(self, state, fp: FluidParams, interactions: Sequence[Interaction] = ()):
        # a state of an earlier window (a guard's rollback snapshot) steps
        # at its own height, and the window follows it from there
        self.wy = self._state_wy(state)
        state = self._frame_fn(self.wy)(state, fp, interactions)
        hits = self._observe(state)
        ny = self.true_config.grid_res[1]
        if hits and self.wy < ny:
            # the fluid is pressing the ceiling: grow at once
            need = min(ny, self._target_wy(self._confirmed) + 2 * self.q)
        else:
            need = self._target_wy(self._confirmed)
            if not (need > self.wy or need <= self.wy - 2 * self.q):
                return state
        if need != self.wy:
            state = self._resize_state(state, need)
            self.wy = need
            self.resizes += 1
        return state
