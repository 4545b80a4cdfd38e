"""Bucket-state engine in plain PyTorch (port of ``mpm_tpu.ops.bucketed``).

Particle state lives permanently in a dense cell-bucket layout

    pos [D, K, C]   vel [D, K, C]   C [D, D, K, C]   mass [K, C]   ids [K, C]

(C = num_cells flat row-major, K = slots per cell; mass == 0 marks an empty
slot, ids == -1). The invariant is floor(pos) == bucket cell. Every pass is
then a gather over the 3^D neighbour buckets at constant flat offsets:

- P2G: for each tap, the contribution of bucket b = c + off to node c is a
  shifted slice of the padded bucket arrays. Row-crossing never corrupts:
  the position clamps keep the edge planes of every axis empty, so wrapped
  or padded reads see mass == 0.
- G2P and the density gather read grid values at b + off.
- Migration replaces sorting: after advection a particle moves at most one
  cell per axis (faster movement is clamped and counted in `cfl_clamped`).
  Migration runs as D axis-split phases; each phase repacks every cell from
  its [stay, from-left, from-right] 3K candidates in slot order. A move whose
  destination cannot take it is rejected before the phase: the particle
  stays in its source cell with its position clamped back inside, is counted
  in `deferred`, and retries next substep, so nothing is dropped.

This module is the CPU engine and the plain version that the CUDA kernels
(ops/cuda/) are held against. Sums over the K slots of a bucket run in slot
order (`_ksum`), the order the kernels use.

Every pass also runs on one slab of an x-slab decomposition
(parallel/domain.py), described by a `Slab`: the arrays' plane 0 sits at a
global x offset, a grid may reach planes past the state's, and the counters
count only the slab's own planes. The default `WHOLE` is the whole grid.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.params import FluidParams, SimConfig
from ..core.state import Grid, SimState, zero_grid
from ..utils.timing import span
from . import bspline, fixed_point
from .grid import update_grid
from .interact import Interaction, apply_interactions
from .stress import eos_pressure

CFL_EPS = 1e-3  # cell + 2 - eps still floors to cell + 1 for any res < 2^10


def cell_top(x: torch.Tensor, n: float) -> torch.Tensor:
    """The highest position a clamp keeps below x + n: (x + n) - CFL_EPS,
    in the JAX source's order (XLA on the CPU folds n - CFL_EPS first,
    tests/torch_xla_ref.folded_tops)."""
    return x + n - CFL_EPS


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """fminf(fmaxf(x, lo), hi), as the kernels clamp: a NaN x gives lo,
    where torch.clamp would keep the NaN. So a particle whose position
    went NaN is clamped into the domain and migrates like any other, its
    NaN left in vel and C, in the plain engine and the kernels alike (the
    JAX engine keeps the NaN in pos and loses the particle at migration,
    uncounted)."""
    lo, hi = (v if torch.is_tensor(v) else x.new_tensor(v) for v in (lo, hi))
    return torch.fmin(torch.fmax(x, lo), hi)


@dataclasses.dataclass(frozen=True)
class Slab:
    """Where a bucket state's arrays sit in an x-slab decomposition
    (parallel/domain.py; the JAX package's kernels take the same as x0,
    their halo planes and their counter gate, fused.py:439-442, 985-996).

    x0: the global plane of the state's plane 0. Only physical coordinates
    (cell centres, migration deltas, boundary bands) use it; neighbour
    indexing stays local, and cells past the array's ends read as empty.
    go: the grid arrays hold `go` more planes than the state on each side of
    axis 0 (grid plane j is state plane j - go).
    c_lo, c_hi: the state planes whose counter events (lost, deferred,
    cfl_clamped, ceiling) count; None = the last plane."""

    x0: int = 0
    go: int = 0
    c_lo: int = 0
    c_hi: int | None = None


WHOLE = Slab()


def _counter(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass
class BucketState:
    pos: torch.Tensor  # [D, K, C] float32
    vel: torch.Tensor  # [D, K, C] float32 or bfloat16
    C: torch.Tensor  # [D, D, K, C] float32 or bfloat16
    mass: torch.Tensor  # [K, C] float32
    ids: torch.Tensor  # [K, C] int32, -1 = empty
    lost: torch.Tensor  # [] int32: particles dropped by bucket overflow
    cfl_clamped: torch.Tensor  # [] int32: CFL bucket-clamp events
    deferred: torch.Tensor  # [] int32: moves rejected and retried next substep
    # y-movers rejected by the air-window ceiling band (ops/window.py). 0
    # across a run certifies that the windowed trajectory equals the
    # full-grid one. Always 0 for non-windowed configs.
    ceiling: torch.Tensor

    @property
    def dim(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kw) -> "BucketState":
        return dataclasses.replace(self, **kw)


def strides(config: SimConfig) -> list[int]:
    s = [1] * config.dim
    for a in range(config.dim - 2, -1, -1):
        s[a] = s[a + 1] * config.grid_res[a + 1]
    return s


def flat_tap_offsets(config: SimConfig) -> list[int]:
    """Flat-index offset of each tap's node on the row-major grid."""
    st = strides(config)
    return [sum((t[a] - 1) * st[a] for a in range(config.dim))
            for t in bspline.taps(config.dim)]


def cell_coords(config: SimConfig, device, dtype=torch.float32, x0: int = 0) -> torch.Tensor:
    """[D, C] integer coordinates of each flat cell, axis 0 offset by x0."""
    i = torch.arange(config.num_cells, dtype=torch.int32, device=device)
    coords = []
    stride = config.num_cells
    for a in range(config.dim):
        stride //= config.grid_res[a]
        coords.append((i // stride) % config.grid_res[a] + (x0 if a == 0 else 0))
    return torch.stack(coords).to(dtype)


def slab_config(config: SimConfig, planes: int) -> SimConfig:
    """The config of a slab of `planes` x-planes of `config`'s grid: array
    extents cut to the slab, physics positions (clamps, walls, bands) at
    the true domain."""
    return config.replace(grid_res=(planes, *config.grid_res[1:]), domain_res=config.dres)


def _grid_config(config: SimConfig, slab: Slab) -> SimConfig:
    """The config of a slab's grid arrays: `slab.go` more planes a side."""
    if not slab.go:
        return config
    return slab_config(config, config.grid_res[0] + 2 * slab.go)


def _pad_planes(x: torch.Tensor, config: SimConfig, go: int) -> torch.Tensor:
    """`go` empty (zero) x-planes on each side of a [..., C] array."""
    pc = config.num_cells // config.grid_res[0]
    return _pad_last(x, go * pc)


def _counted(config: SimConfig, slab: Slab, device) -> torch.Tensor | None:
    """[C] bool: the cells whose counter events count (None: every cell)."""
    nx = config.grid_res[0]
    c_hi = nx - 1 if slab.c_hi is None else slab.c_hi
    if slab.c_lo <= 0 and c_hi >= nx - 1:
        return None
    plane = cell_coords(config, device, torch.int32)[0]
    return (plane >= slab.c_lo) & (plane <= c_hi)


def _count(events: torch.Tensor, gate: torch.Tensor | None) -> torch.Tensor:
    """int32 count of the true entries of `events` ([..., C]) in counted cells."""
    if gate is not None:
        events = events & gate
    return events.sum(dtype=torch.int32)


def _pad_last(x: torch.Tensor, h: int) -> torch.Tensor:
    return F.pad(x, (h, h)) if h else x


def _shift(padded: torch.Tensor, h: int, off: int, c: int) -> torch.Tensor:
    """R[c] = original[c + off]; `padded` is padded along the last axis by h."""
    return padded[..., h + off: h + off + c]


def _ksum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the slot axis (-2) in slot order."""
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc


def _encode(x, config: SimConfig):
    if config.fixed_point:
        return fixed_point.encode(x, config.fixed_point_mult)
    return x


def _decode(x, config: SimConfig):
    if config.fixed_point:
        return fixed_point.decode(x, config.fixed_point_mult, config.dtype)
    return x


# ---------------------------------------------------------------- transfers


def _tap_geometry(config: SimConfig, device, x0: int = 0):
    """(halo h, cell centres [D, C], taps, their flat offsets, their
    offsets [D, 1, 1] as floats)."""
    h = sum(strides(config))
    center = cell_coords(config, device, x0=x0) + 0.5  # [D, C]
    taps = bspline.taps(config.dim)
    ovs = [torch.tensor([float(t[a] - 1) for a in range(config.dim)], device=device)
           .reshape(config.dim, 1, 1) for t in taps]
    return h, center, taps, flat_tap_offsets(config), ovs


def p2g_pass1(state: BucketState, config: SimConfig, slab: Slab = WHOLE) -> Grid:
    """P2G pass 1 (p2g_1.glsl): grid mass and APIC momentum, each slot's
    contribution encoded for a fixed-point config. On a slab the grid has
    slab.go more planes a side, as if the state had empty planes there."""
    gcfg = _grid_config(config, slab)
    dev = state.device
    h, center, taps, offs, ovs = _tap_geometry(gcfg, dev, slab.x0 - slab.go)
    c = gcfg.num_cells

    def pad(x):  # the state on the grid's planes, then the flat halo
        return _pad_last(_pad_planes(x, config, slab.go), h)

    pos_p = pad(state.pos)
    # vel/C may be stored bf16; all arithmetic is float32
    vel_p = pad(state.vel.to(state.pos.dtype))
    C_p = pad(state.C.to(state.pos.dtype))
    mass_p = pad(state.mass)

    grid0 = zero_grid(gcfg, dev)
    gmass, gmom = grid0.mass, grid0.mom
    # node c gathers from bucket b = c + off with the reflected tap 2 - t
    # (the tap set is symmetric); the particle's offset from its own cell
    # center is d = pos - (center[c] + off)
    for tap, off, ov in zip(taps, offs, ovs):
        P = _shift(pos_p, h, off, c)
        M = _shift(mass_p, h, off, c)
        V = _shift(vel_p, h, off, c)
        CB = _shift(C_p, h, off, c)
        tap_r = tuple(2 - t_a for t_a in tap)
        d = P - (center[:, None, :] + ov)
        w = bspline.tap_weight(d, tap_r) * (M > 0)
        dist = bspline.tap_dist(d, tap_r)
        mass_c = w * M
        Cd = bspline.matvec(CB, dist)
        mom_c = mass_c * (V + Cd)
        gmass = gmass + _ksum(_encode(mass_c, config))
        gmom = gmom + _ksum(_encode(mom_c, config))
    return Grid(mom=gmom, mass=gmass)


def force_coefs(state: BucketState, gmass: torch.Tensor, config: SimConfig,
                fp: FluidParams, slab: Slab = WHOLE) -> tuple[torch.Tensor, torch.Tensor]:
    """The density gather from the pass-1 grid mass, the EOS, and pass 2's
    force coefficients (a_p, b_mu), each [K, C]."""
    dim, k, c = state.pos.shape
    dev = state.device
    h, center, taps, offs, _ = _tap_geometry(config, dev, slab.x0)
    go = slab.go * (c // config.grid_res[0])  # the grid's extra cells a side
    gmass_pad = _pad_last(gmass, h)
    density = torch.zeros((k, c), dtype=state.pos.dtype, device=dev)
    d_own = state.pos - center[:, None, :]  # [D, K, C] = frac - 0.5
    for tap, off in zip(taps, offs):
        gm = _decode(_shift(gmass_pad, h, off + go, c), config)
        w = bspline.tap_weight(d_own, tap)
        density = density + w * gm[None, :]

    occ = state.mass > 0
    safe_density = torch.where(occ, density, 1.0)
    volume = torch.where(occ, state.mass / safe_density, 0.0)
    pressure = eos_pressure(safe_density, fp, config.eos_power_static)
    coef = (-4.0 * fp.dt) * volume  # [K, C]
    return coef * (-pressure), coef * fp.dynamic_viscosity


def p2g_pass2(state: BucketState, a_p: torch.Tensor, b_mu: torch.Tensor,
              gmom: torch.Tensor, config: SimConfig, slab: Slab = WHOLE) -> torch.Tensor:
    """P2G pass 2 (p2g_2.glsl): the EOS and viscosity force momentum added
    to `gmom` tap by tap, encoded for a fixed-point config. On a slab `gmom`
    has slab.go more planes a side than the state."""
    dim = state.dim
    gcfg = _grid_config(config, slab)
    dev = state.device
    h, center, taps, offs, ovs = _tap_geometry(gcfg, dev, slab.x0 - slab.go)
    c = gcfg.num_cells

    def pad(x):
        return _pad_last(_pad_planes(x, config, slab.go), h)

    pos_p = pad(state.pos)
    C_p = pad(state.C.to(state.pos.dtype))
    mass_p = pad(state.mass)
    a_p_pad = pad(a_p)
    b_mu_pad = pad(b_mu)
    for tap, off, ov in zip(taps, offs, ovs):
        P = _shift(pos_p, h, off, c)
        M = _shift(mass_p, h, off, c)
        CB = _shift(C_p, h, off, c)
        AP = _shift(a_p_pad, h, off, c)
        BM = _shift(b_mu_pad, h, off, c)
        tap_r = tuple(2 - t_a for t_a in tap)
        d = P - (center[:, None, :] + ov)
        w = bspline.tap_weight(d, tap_r) * (M > 0)
        dist = bspline.tap_dist(d, tap_r)
        if config.legacy_strain:
            # 2D serial variant strain (MLSMPM2DFluid.cs:276-281)
            Ct = CB.transpose(0, 1)
            eye = torch.eye(dim, device=dev)[:, :, None, None]
            Sd = bspline.matvec(CB + Ct - eye * Ct, dist)
        else:
            Sd = bspline.matvec(CB, dist) + bspline.matvec_t(CB, dist)
        mom_c = w * (AP * dist + BM * Sd)
        gmom = gmom + _ksum(_encode(mom_c, config))
    return gmom


def p2g_bucketed(state: BucketState, config: SimConfig, fp: FluidParams) -> Grid:
    """Both P2G passes as dense windowed sums (p2g_1.glsl + p2g_2.glsl), pass
    2 added onto pass 1's momentum."""
    g1 = p2g_pass1(state, config)
    a_p, b_mu = force_coefs(state, g1.mass, config, fp)
    return Grid(mom=p2g_pass2(state, a_p, b_mu, g1.mom, config), mass=g1.mass)


def g2p_gather(state: BucketState, grid: Grid, config: SimConfig,
               slab: Slab = WHOLE) -> tuple[torch.Tensor, torch.Tensor]:
    """The windowed G2P gather (g2p.glsl:73-108): float32 vel [D, K, C] and
    C = 4B [D, D, K, C], not yet zeroed at empty slots. On a slab the grid
    velocity has slab.go more planes a side than the state."""
    dim, k, c = state.pos.shape
    dev = state.device
    h = sum(strides(config))
    go = slab.go * (c // config.grid_res[0])
    center = cell_coords(config, dev, x0=slab.x0) + 0.5
    d_own = state.pos - center[:, None, :]

    gvel_pad = _pad_last(grid.mom, h)
    vel = torch.zeros(state.vel.shape, dtype=state.pos.dtype, device=dev)
    B = torch.zeros(state.C.shape, dtype=state.pos.dtype, device=dev)
    for tap, off in zip(bspline.taps(dim), flat_tap_offsets(config)):
        gv = _decode(_shift(gvel_pad, h, off + go, c), config)  # [D, C] at b + off
        w = bspline.tap_weight(d_own, tap)  # [K, C]
        dist = bspline.tap_dist(d_own, tap)  # [D, K, C]
        wv = w[None] * gv[:, None, :]
        vel = vel + wv
        B = B + wv[:, None] * dist[None]
    return vel, 4.0 * B


def advect_tail(state: BucketState, vel: torch.Tensor, Cmat: torch.Tensor,
                config: SimConfig, fp: FluidParams,
                interactions: Sequence[Interaction] = (), slab: Slab = WHOLE) -> BucketState:
    """The tail after the G2P gather (g2p.glsl:110-147): advect, clamp,
    interactions, wall springs, the CFL bucket clamp and its count; empty
    slots parked at the cell centre with zero vel and C, stored in the
    storage type."""
    dev = state.device
    center = cell_coords(config, dev, x0=slab.x0) + 0.5
    pos = state.pos + vel * fp.dt
    res = torch.tensor(config.dres, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    pos = _clip(pos, config.clamp_lo, res - config.clamp_hi_offset)

    vel = apply_interactions(pos, vel, interactions)

    x_n = pos + vel
    lo = config.wall_min
    hi = res - config.wall_max_offset
    vel = vel + config.wall_stiffness * (
        torch.clamp(lo - x_n, min=0.0) + torch.clamp(hi - x_n, max=0.0)
    )

    occ = state.mass > 0
    # CFL bucket clamp: a particle faster than one cell per substep would
    # leave its bucket's +-1-cell migration range; clamp it and count it
    cell = center[:, None, :] - 0.5
    pos_cfl = _clip(pos, cell - 1.0, cell_top(cell, 2.0))
    moved = occ & torch.any(pos_cfl != pos, dim=0)
    pos = pos_cfl

    pos = torch.where(occ, pos, center[:, None, :])  # park empties in-cell
    vel = torch.where(occ, vel, 0.0)
    Cmat = torch.where(occ, Cmat, 0.0)
    return state.replace(
        pos=pos,
        vel=vel.to(config.vc_dtype),
        C=Cmat.to(config.vc_dtype),
        cfl_clamped=state.cfl_clamped + _count(moved, _counted(config, slab, dev)),
    )


def g2p_bucketed(state: BucketState, grid: Grid, config: SimConfig,
                 fp: FluidParams, interactions: Sequence[Interaction] = (),
                 slab: Slab = WHOLE) -> BucketState:
    """Windowed G2P gather and the advection tail (g2p.glsl:52-147)."""
    vel, Cmat = g2p_gather(state, grid, config, slab)
    return advect_tail(state, vel, Cmat, config, fp, interactions, slab)


# ---------------------------------------------------------------- migration


def _shift_cells(x: torch.Tensor, off: int) -> torch.Tensor:
    """Value at cell c taken from flat cell c + off (zero outside)."""
    if off == 0:
        return x
    h = abs(off)
    return _shift(_pad_last(x, h), h, off, x.shape[-1])


def reject_overflow(state: BucketState, config: SimConfig, axis: int,
                    slab: Slab = WHOLE) -> BucketState:
    """Overflow rejection along one axis, before the migration phase. A mover
    whose destination cannot take it stays in its source cell with pos
    clamped back inside (counted in `deferred`). Incoming candidate i (in
    [from-left, from-right] order) is accepted iff occ0(dest) + i < K, with
    occ0 the destination's occupancy before the phase. Stayers plus rejected
    own movers never exceed occ0(source) <= K, and every accepted incoming
    lands at rank <= occ0 + i < K, so no bucket exceeds K. Both ends of an
    exchange evaluate the same formula on the same state, so they agree."""
    dim, k, c = state.pos.shape
    stride = strides(config)[axis]
    coord = cell_coords(config, state.device, x0=slab.x0)[axis]
    gate = _counted(config, slab, state.device)
    delta = _clip(torch.floor(state.pos[axis]) - coord[None, :], -1.0, 1.0)
    occ = state.mass > 0

    occ0 = occ.sum(dim=0, dtype=torch.int32)  # [C]
    movr = occ & (delta == 1.0)
    movl = occ & (delta == -1.0)
    rank_r = torch.cumsum(movr.to(torch.int32), dim=0, dtype=torch.int32) - 1
    rank_l = torch.cumsum(movl.to(torch.int32), dim=0, dtype=torch.int32) - 1
    nmovr = movr.sum(dim=0, dtype=torch.int32)

    # a right-mover's index among its destination's incoming candidates is
    # its rank among the source's right-movers; a left-mover's is the
    # destination's from-left count (right-movers of source - 2) plus its
    # rank among left-movers
    pr_r = _shift_cells(occ0, stride)[None, :] + rank_r
    pr_l = (_shift_cells(occ0, -stride)[None, :]
            + _shift_cells(nmovr, -2 * stride)[None, :] + rank_l)
    rej = (movr & (pr_r >= k)) | (movl & (pr_l >= k))
    ceiling = state.ceiling
    if (axis == 1 and config.domain_res is not None
            and config.grid_res[1] < config.domain_res[1]):
        # air-window ceiling: upward moves out of the window's top band are
        # rejected like a full destination, and counted apart
        band = coord >= config.grid_res[1] - 4
        rej_ceil = movr & band[None, :] & ~rej
        rej = rej | rej_ceil
        ceiling = ceiling + _count(rej_ceil, gate)
    pos_ax = _clip(state.pos[axis], coord[None, :], cell_top(coord[None, :], 1.0))
    new_pos = state.pos.clone()
    new_pos[axis] = torch.where(rej, pos_ax, state.pos[axis])
    return state.replace(pos=new_pos,
                         deferred=state.deferred + _count(rej, gate),
                         ceiling=ceiling)


def _migrate_axis(state: BucketState, config: SimConfig, axis: int,
                  slab: Slab = WHOLE) -> BucketState:
    """One axis-split migration phase: repack every cell from its [stay,
    from-left, from-right] 3K candidates, in slot order, after overflow
    rejection (reject_overflow)."""
    dim, k, c = state.pos.shape
    stride = strides(config)[axis]
    coord = cell_coords(config, state.device, x0=slab.x0)[axis]

    state = reject_overflow(state, config, axis, slab)

    delta = _clip(torch.floor(state.pos[axis]) - coord[None, :], -1.0, 1.0)
    occ = state.mass > 0

    # candidates arriving at cell c moving by `s` come from cell c - s
    shifts = (0, 1, -1)
    cand_mask = torch.cat(
        [_shift_cells(occ & (delta == float(s)), -s * stride) for s in shifts], dim=0)

    def gather_field(x):
        return torch.cat([_shift_cells(x, -s * stride) for s in shifts], dim=-2)

    rank = torch.cumsum(cand_mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    total = cand_mask.sum(dim=0, dtype=torch.int32)
    excess = torch.clamp(total - k, min=0)
    gate = _counted(config, slab, state.device)
    if gate is not None:
        excess = torch.where(gate, excess, 0)
    lost = state.lost + excess.sum(dtype=torch.int32)

    # select: candidate j lands in slot rank[j] when rank[j] < K; the rest go
    # to a dump slot K that is cut away (those are the `lost` ones)
    dest = torch.where(cand_mask & (rank < k), rank, k).to(torch.int64)  # [3K, C]

    def select(x):
        cand = gather_field(x)
        lead = cand.shape[:-2]
        out = torch.zeros((*lead, k + 1, c), dtype=x.dtype, device=x.device)
        idx = dest.expand(*lead, 3 * k, c)
        out.scatter_(-2, idx, cand)
        return out[..., :k, :].contiguous()

    new_mass = select(state.mass)
    new_ids = torch.where(new_mass > 0, select(state.ids), -1)
    return state.replace(pos=select(state.pos), vel=select(state.vel),
                         C=select(state.C), mass=new_mass, ids=new_ids, lost=lost)


def migrate(state: BucketState, config: SimConfig, slab: Slab = WHOLE) -> BucketState:
    # last axis first (3D: z, y, x): slot assignment depends on arrival
    # order, and this is the JAX package's and the kernel's order
    for a in range(config.dim - 1, -1, -1):
        state = _migrate_axis(state, config, a, slab)
    return state


# ----------------------------------------------------------------- substep


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    """One plain substep; its halves open the spans of kernels P and F."""
    with span("mpm.kernel.p2g"):
        grid = p2g_bucketed(state, config, fp)
        grid = update_grid(grid, config, fp)
    with span("mpm.kernel.g2p"):
        state = g2p_bucketed(state, grid, config, fp, interactions)
        return migrate(state, config)


# ------------------------------------------------------------- conversions


def from_simstate(state: SimState, config: SimConfig) -> BucketState:
    """Pack a linear SimState into buckets (set-up time). Slot order is the
    JAX package's: a stable sort by the clipped flat base cell
    (binned.sort_by_cell), then the first K particles of each cell
    (binning.bin_slots); the excess is counted in `lost`."""
    dev = state.pos.device
    n = state.num_particles
    k = config.bin_capacity
    base = torch.floor(state.pos).to(torch.int32)
    flat = torch.zeros((n,), dtype=torch.int32, device=dev)
    for a in range(config.dim):
        b_a = torch.clamp(base[a], 1, config.grid_res[a] - 2)
        flat = flat * config.grid_res[a] + b_a
    order = torch.argsort(flat, stable=True)
    cid = flat[order].contiguous()
    seg_start = torch.searchsorted(
        cid, torch.arange(config.num_cells + 1, dtype=torch.int32, device=dev))
    count = seg_start[1:] - seg_start[:-1]  # [C]
    ks = torch.arange(k, device=dev)
    valid = ks[None, :] < count[:, None]
    slot = torch.where(valid, seg_start[:-1, None] + ks[None, :], n).T  # [K, C]
    src = torch.cat([order, torch.zeros((1,), dtype=order.dtype, device=dev)])
    live = valid.T

    def pack(field):  # [..., N] -> [..., K, C], empty slots 0
        out = field[..., src[slot]]
        return torch.where(live, out, torch.zeros((), dtype=out.dtype, device=dev))

    mass = pack(state.mass)
    ids = torch.where(mass > 0, pack(state.ids), -1)
    center = cell_coords(config, dev, state.pos.dtype) + 0.5
    pos = torch.where(mass > 0, pack(state.pos), center[:, None, :])
    return BucketState(
        pos=pos.contiguous(),
        vel=pack(state.vel).to(config.vc_dtype).contiguous(),
        C=pack(state.C).to(config.vc_dtype).contiguous(),
        mass=mass.contiguous(),
        ids=ids.to(torch.int32).contiguous(),
        lost=torch.clamp(count - k, min=0).sum(dtype=torch.int32),
        cfl_clamped=_counter(dev),
        deferred=_counter(dev),
        ceiling=_counter(dev),
    )


def to_simstate(bstate: BucketState) -> SimState:
    """Unpack to a linear SimState in emission order (host and test path)."""
    dim = bstate.dim
    mass = bstate.mass.reshape(-1)
    idx = torch.nonzero(mass > 0).squeeze(1)
    ids = bstate.ids.reshape(-1)[idx]
    order = torch.argsort(ids)
    idx = idx[order]
    return SimState(
        pos=bstate.pos.reshape(dim, -1)[:, idx],
        vel=bstate.vel.reshape(dim, -1)[:, idx],
        C=bstate.C.reshape(dim, dim, -1)[:, :, idx],
        mass=mass[idx],
        ids=ids[order],
    )
