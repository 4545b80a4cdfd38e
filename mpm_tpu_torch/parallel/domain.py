"""X-slab domain decomposition of the bucket state (port of the bucket half
of ``mpm_tpu.parallel.domain``, domain.py:517-746).

The JAX package runs it as one program over a device mesh (shard_map,
ppermute). Here one process drives every slab: a `SlabMesh` is a list of
torch devices, one per slab, and it may repeat a device (four slabs on one
card are the counterpart of the JAX package's virtual CPU mesh). A sharded
state (`ShardedState`) holds one BucketState per slab on its device: slab
`a` owns the nx / n x-planes from global plane a * nx / n, plane-major,
exactly the JAX package's slice of the global [.., K, C] arrays. Per
substep, on every slab:

  1. state halo: the neighbours' two nearest planes a side are copied in
     (dead planes, mass 0 and ids -1, past the global ends), so the slab
     computes its halo planes' G2P and migration itself and the overflow
     decisions at a boundary agree on both sides without a merge;
  2. stage 1 of kernel P (ops/cuda/p2g_shard.py): grid mass and pass-1
     momentum on the slab's grid of L + 2 planes;
  3. grid-mass exchange: the two end planes a side, incomplete here, are
     replaced by the neighbours' complete ones (zero past the global ends);
  4. stage 2 of kernel P: force and grid update from the exact mass;
  5. grid-velocity exchange, as 3;
  6. kernel F in shard mode (G2P, tail, migration; with the render's splat
     emission on request), then the slab's own planes are kept.

The exchanges are slicing and torch.cat of neighbour planes copied with
`.to(device)`: between two cards PyTorch orders that copy after the work
already queued on both devices' current streams, and on one card stream
order does it. Counters count the slab's own planes only (the kernels'
gate) and each slab's deltas are summed once per frame, as the JAX
package's psum. The sort-based sharded step of the binned engine
(domain.py:49-514) waits with that engine.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.params import FluidParams, SimConfig
from ..core.state import Grid
from ..ops.bucketed import BucketState, Slab, from_simstate, slab_config
from ..ops.cuda import p2g_shard
from ..ops.cuda.extract_cells import cell_splats_plain
from ..ops.cuda.g2p_migrate import g2p_migrate, g2p_migrate_plain
from ..ops.interact import Interaction

COUNTERS = ("lost", "cfl_clamped", "deferred", "ceiling")
HALO = 2  # state halo planes a side (the migration's reach plus one)


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """The devices of the slabs, in x order; a device may repeat."""

    devices: tuple[torch.device, ...]

    @staticmethod
    def of(devices: Sequence) -> "SlabMesh":
        return SlabMesh(tuple(torch.device(d) for d in devices))

    @staticmethod
    def on(device, n: int) -> "SlabMesh":
        """n slabs on one device."""
        return SlabMesh.of([device] * n)

    @property
    def n(self) -> int:
        return len(self.devices)


@dataclasses.dataclass
class ShardedState:
    """One BucketState per slab, each on its mesh device. Every slab's
    counters hold the totals over all slabs."""

    slabs: list[BucketState]

    @property
    def lost(self) -> torch.Tensor:
        return self.slabs[0].lost

    @property
    def cfl_clamped(self) -> torch.Tensor:
        return self.slabs[0].cfl_clamped

    @property
    def deferred(self) -> torch.Tensor:
        return self.slabs[0].deferred

    @property
    def ceiling(self) -> torch.Tensor:
        return self.slabs[0].ceiling


def slab_planes(config: SimConfig, n: int) -> int:
    """Planes a slab owns; raises unless nx splits into n slabs of >= 2."""
    nx = config.grid_res[0]
    if config.dim != 3:
        raise ValueError("the slab decomposition is 3D")
    if n < 1 or nx % n or nx // n < HALO:
        raise ValueError(f"{n} slabs must divide grid x={nx} into slabs of >= {HALO} planes")
    return nx // n


def _plane_cells(config: SimConfig) -> int:
    return config.num_cells // config.grid_res[0]


def _planes(x: torch.Tensor, pc: int, lo: int, hi: int) -> torch.Tensor:
    """Planes [lo, hi) of a [..., C] array."""
    return x[..., lo * pc:hi * pc]


def shard_bucket_state(bstate: BucketState, config: SimConfig, mesh: SlabMesh) -> ShardedState:
    """Split a whole-grid BucketState into the mesh's slabs."""
    loc, pc = slab_planes(config, mesh.n), _plane_cells(config)
    slabs = []
    for a, dev in enumerate(mesh.devices):
        arrays = {f: _planes(getattr(bstate, f), pc, a * loc, (a + 1) * loc).to(dev).contiguous()
                  for f in ("pos", "vel", "C", "mass", "ids")}
        counters = {f: getattr(bstate, f).to(dev).clone() for f in COUNTERS}
        slabs.append(BucketState(**arrays, **counters))
    return ShardedState(slabs)


def gather_bucket_state(state: ShardedState) -> BucketState:
    """The inverse of shard_bucket_state: the slabs concatenated into one
    BucketState on the first slab's device, slot for slot."""
    dev = state.slabs[0].device
    arrays = {f: torch.cat([getattr(s, f).to(dev) for s in state.slabs], dim=-1)
              for f in ("pos", "vel", "C", "mass", "ids")}
    counters = {f: getattr(state, f).to(dev) for f in COUNTERS}
    return BucketState(**arrays, **counters)


def _dead_planes(like: torch.Tensor, pc: int, fill) -> torch.Tensor:
    shape = (*like.shape[:-1], HALO * pc)
    return torch.full(shape, fill, dtype=like.dtype, device=like.device)


def _exchange_state_halo(slabs: list[BucketState], pc: int) -> list[BucketState]:
    """The padded slabs: [left neighbour's last 2 planes | own | right
    neighbour's first 2 planes]; dead planes past the global ends."""
    n = len(slabs)
    out = []
    for a, s in enumerate(slabs):
        def pad(field, fill):
            x = getattr(s, field)
            lo = (getattr(slabs[a - 1], field)[..., -HALO * pc:].to(x.device) if a > 0
                  else _dead_planes(x, pc, fill))
            hi = (getattr(slabs[a + 1], field)[..., :HALO * pc].to(x.device) if a < n - 1
                  else _dead_planes(x, pc, fill))
            return torch.cat([lo, x, hi], dim=-1)

        out.append(s.replace(pos=pad("pos", 0.0), vel=pad("vel", 0.0), C=pad("C", 0.0),
                             mass=pad("mass", 0.0), ids=pad("ids", -1)))
    return out


def _exchange_grid(gs: list[torch.Tensor], loc: int, pc: int) -> list[torch.Tensor]:
    """Replace the incomplete end planes of each slab's grid ([..., (loc+6)
    * pc]: grid plane j is global plane x0 - 1 + j, complete on [2, loc+3])
    with the neighbours' complete ones, zero past the global ends."""
    n = len(gs)
    out = []
    for a, g in enumerate(gs):
        lo = (_planes(gs[a - 1], pc, loc, loc + 2).to(g.device) if a > 0
              else torch.zeros_like(_planes(g, pc, 0, 2)))
        hi = (_planes(gs[a + 1], pc, 4, 6).to(g.device) if a < n - 1
              else torch.zeros_like(_planes(g, pc, 0, 2)))
        out.append(torch.cat([lo, _planes(g, pc, 2, loc + 4), hi], dim=-1))
    return out


def _f_kernels(padded, grid, config, fp, inter, slab, rscals):
    if rscals is None:
        return g2p_migrate(padded, grid, config, fp, inter, slab=slab), None
    return g2p_migrate(padded, grid, config, fp, inter, emit_splats=True,
                       render_scals=rscals, slab=slab)


def _f_plain(padded, grid, config, fp, inter, slab, rscals):
    out = g2p_migrate_plain(padded, grid, config, fp, inter, slab)
    if rscals is None:
        return out, None
    return out, cell_splats_plain(out.pos, out.vel, out.mass, rscals)


def _stages(mode: str):
    """(stage 1, stage 2, kernel F) of a step mode: the kernel wrappers for
    "auto" and "cuda" (each takes its plain version on the CPU), the plain
    versions for "bucketed"."""
    if mode == "bucketed":
        return p2g_shard.p2g1_shard_plain, p2g_shard.p2g2u_shard_plain, _f_plain
    if mode in ("auto", "cuda"):
        return p2g_shard.p2g1_shard, p2g_shard.p2g2u_shard, _f_kernels
    raise ValueError(f"unknown step mode: {mode}")


def make_sharded_frame_fn(config: SimConfig, mesh: SlabMesh, substeps: int | None = None,
                          mode: str = "auto"):
    """(state, fluid, interactions, render_scals=None) -> (state, splats):
    `substeps` sharded substeps; with render scalars the last one's kernel
    F emits each slab's splats of its own planes ([5, loc * pc] a slab),
    else splats is None."""
    loc = slab_planes(config, mesh.n)
    pc = _plane_cells(config)
    n_pad = loc + 2 * HALO
    cfg = slab_config(config, n_pad)
    nsub = substeps if substeps is not None else config.substeps
    stage1, stage2, kernel_f = _stages(mode)
    x0s = [a * loc - HALO for a in range(mesh.n)]
    gates = [Slab(x0=x0, go=1, c_lo=HALO, c_hi=n_pad - 1 - HALO) for x0 in x0s]
    own = slice(HALO * pc, (HALO + loc) * pc)

    def substep(slabs, fp, inter, rscals):
        padded = _exchange_state_halo(slabs, pc)
        g1 = [stage1(p, cfg, fp, x0) for p, x0 in zip(padded, x0s)]
        gmass = _exchange_grid([g.mass for g in g1], loc, pc)
        gvel = [stage2(p, Grid(mom=g.mom, mass=m), cfg, fp, x0)
                for p, g, m, x0 in zip(padded, g1, gmass, x0s)]
        gvel = _exchange_grid(gvel, loc, pc)
        out, splats = [], []
        for p, gv, m, gate in zip(padded, gvel, gmass, gates):
            s, sp = kernel_f(p, Grid(mom=gv, mass=m), cfg, fp, inter, gate, rscals)
            out.append(s.replace(pos=s.pos[..., own], vel=s.vel[..., own], C=s.C[..., own],
                                 mass=s.mass[..., own], ids=s.ids[..., own]))
            # the halo planes' splats come from incomplete state: dropped
            splats.append(None if sp is None else sp[:, own])
        return out, splats

    def frame(state: ShardedState, fp: FluidParams, interactions: Sequence[Interaction] = (),
              render_scals: torch.Tensor | None = None):
        totals = [getattr(state, f) for f in COUNTERS]
        slabs = [s.replace(**{f: torch.zeros((), dtype=torch.int32, device=s.device)
                              for f in COUNTERS}) for s in state.slabs]
        splats = None
        for i in range(nsub):
            rs = render_scals if i == nsub - 1 else None
            slabs, splats = substep(slabs, fp, interactions, rs)
        # each slab counted its own planes' events: the totals are the sums
        for f, c0 in zip(COUNTERS, totals):
            total = c0 + sum(getattr(s, f).to(c0.device) for s in slabs)
            slabs = [s.replace(**{f: total.to(s.device)}) for s in slabs]
        return ShardedState(slabs), (splats if render_scals is not None else None)

    return frame


def make_sharded_bucket_step(config: SimConfig, mesh: SlabMesh, substeps: int | None = None,
                             mode: str = "auto"):
    """The sharded frame step (state, fluid, interactions) -> state over a
    ShardedState: `substeps` (default config.substeps) substeps of kernel
    P's two shard stages and kernel F in shard mode on every slab (their
    plain versions under mode "bucketed" or on the CPU). Requires nx % n ==
    0 and slabs of >= 2 planes."""
    fn = make_sharded_frame_fn(config, mesh, substeps, mode)

    def step(state: ShardedState, fp: FluidParams,
             interactions: Sequence[Interaction] = ()) -> ShardedState:
        return fn(state, fp, interactions)[0]

    return step


def _check_equal(got: BucketState, want: BucketState, label: str) -> None:
    for f in ("pos", "vel", "C", "mass", "ids", *COUNTERS):
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b.to(a.device)):
            raise AssertionError(f"{label}: the sharded step's {f} differs from the "
                                 "unsharded step's")


def demo_sharded_bucket_step(n_slabs: int, device="cuda") -> None:
    """One sharded substep of a tiny scene on n_slabs slabs of one device
    (domain.py:702-746): plain f32, a y-windowed config (true-domain walls,
    the ceiling band) and bf16 vel/C storage. Each must lose no particle
    and equal the unsharded step (ops/step.make_step) slot for slot."""
    from ..models.scenes import fluid_3d
    from ..ops.step import make_step
    from ..ops.window import window_config

    mesh = SlabMesh.on(device, n_slabs)
    scene = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=device)
    config = scene.config.replace(substeps=1, bin_capacity=8)
    tall = config.replace(grid_res=(16, 32, 16))
    runs = {"f32": config, "windowed": window_config(tall, 16),
            "bf16": config.replace(storage_dtype="bfloat16")}
    for label, cfg in runs.items():
        b0 = from_simstate(scene.state, cfg)
        out = make_sharded_bucket_step(cfg, mesh, substeps=1)(
            shard_bucket_state(b0, cfg, mesh), scene.fluid)
        if int(out.lost) != 0:
            raise AssertionError(f"demo_sharded_bucket_step ({label}): lost {int(out.lost)}")
        want = make_step(cfg, substeps=1)(b0, scene.fluid)
        _check_equal(gather_bucket_state(out), want, f"demo_sharded_bucket_step ({label})")
