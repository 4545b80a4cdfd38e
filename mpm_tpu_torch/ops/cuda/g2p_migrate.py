"""Kernel F: G2P, the advection tail and 3-axis bucket migration in one
hand-written CUDA kernel chain (csrc/g2p_migrate.cu), beside its plain
PyTorch version, with the optional per-cell splat emission of the render
path.

`g2p_migrate(state, grid, config, fp, interactions)` takes the plain
version for a state on the CPU and launches the kernel for a state on a
CUDA device; there is no other fallback. The grid velocity is float32, or
int32 for a fixed-point config, decoded as the kernel reads it.

Shard mode (`slab`, parallel/domain.py): the state is a padded slab, the
grid velocity has slab.go more planes a side, physical coordinates take the
global offset slab.x0, and the counters count the planes [slab.c_lo,
slab.c_hi] only (ops/bucketed.Slab).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ...core.state import Grid
from ...utils.timing import spanned
from ..bucketed import WHOLE, BucketState, Slab, g2p_bucketed, migrate
from ..interact import Interaction, interaction_rows
from . import build
from .extract_cells import cell_splats_plain, render_scals_for, scals_arg
from .p2g_update import check_state, check_supported

__all__ = ["g2p_migrate", "g2p_migrate_plain", "render_scals_for"]

launches = 0  # kernel launches by g2p_migrate (plain-version calls not counted)
emit_launches = 0  # of those, launches that emitted splats
shard_launches = 0  # of those, launches in shard mode


class SlabC(ctypes.Structure):
    """Mirror of mpm::Slab in csrc/mpm_common.cuh."""

    _fields_ = [("x0", ctypes.c_int), ("go", ctypes.c_int),
                ("c_lo", ctypes.c_int), ("c_hi", ctypes.c_int)]


def slab_arg(slab: Slab) -> SlabC:
    return SlabC(slab.x0, slab.go, slab.c_lo,
                 0x7FFFFFFF if slab.c_hi is None else slab.c_hi)


class G2PParams(ctypes.Structure):
    """Mirror of G2PParams in csrc/g2p_migrate.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("K", ctypes.c_int), ("C", ctypes.c_int),
        ("dres", ctypes.c_int * 3),
        ("n_inter", ctypes.c_int), ("ceil_band_y", ctypes.c_int), ("slab", SlabC),
        ("dt", ctypes.c_float),
        ("clamp_lo", ctypes.c_float), ("clamp_hi_offset", ctypes.c_float),
        ("wall_min", ctypes.c_float), ("wall_max_offset", ctypes.c_float),
        ("wall_stiffness", ctypes.c_float), ("fixed_mult", ctypes.c_float),
        ("inter", ctypes.c_void_p),
    ]


def g2p_migrate_plain(state: BucketState, grid: Grid, config: SimConfig,
                      fp: FluidParams, interactions: Sequence[Interaction] = (),
                      slab: Slab = WHOLE) -> BucketState:
    """The plain PyTorch version: bucketed.g2p_bucketed + bucketed.migrate."""
    return migrate(g2p_bucketed(state, grid, config, fp, interactions, slab), config, slab)


def ceiling_band_y(config: SimConfig) -> int:
    """First y cell of the air-window ceiling band, or -1 when the config is
    not y-windowed (bucketed.reject_overflow)."""
    if config.domain_res is not None and config.grid_res[1] < config.domain_res[1]:
        return config.grid_res[1] - 4
    return -1


def _params(config: SimConfig, fp: FluidParams, inter: torch.Tensor | None, n_inter: int,
            slab: Slab) -> G2PParams:
    p = G2PParams()
    p.nx, p.ny, p.nz = config.grid_res
    p.K, p.C = config.bin_capacity, config.num_cells
    p.dres[:] = list(config.dres)
    p.n_inter = n_inter
    p.ceil_band_y = ceiling_band_y(config)
    p.slab = slab_arg(slab)
    p.dt = float(fp.dt)
    p.clamp_lo, p.clamp_hi_offset = config.clamp_lo, config.clamp_hi_offset
    p.wall_min, p.wall_max_offset = config.wall_min, config.wall_max_offset
    p.wall_stiffness = config.wall_stiffness
    p.fixed_mult = config.fixed_point_mult
    p.inter = None if inter is None else inter.data_ptr()
    return p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("g2p_migrate")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.g2p_migrate.argtypes = [vp] * 18 + [ci, ci, vp, vp, vp]
    lib.g2p_migrate.restype = ci
    lib.g2p_migrate_params_size.argtypes = []
    lib.g2p_migrate_params_size.restype = ci
    if lib.g2p_migrate_params_size() != ctypes.sizeof(G2PParams):
        raise RuntimeError("G2PParams layout differs between csrc and Python")
    return lib


@spanned("mpm.kernel.g2p")
def g2p_migrate(state: BucketState, grid: Grid, config: SimConfig,
                fp: FluidParams, interactions: Sequence[Interaction] = (),
                emit_splats: bool = False, render_scals: torch.Tensor | None = None,
                slab: Slab = WHOLE):
    """G2P + tail + migration: the plain version on the CPU, kernel F on CUDA.

    With emit_splats=True it returns (state, splats): splats [5, C] are the
    per-cell splat points of the result (ops/cuda/extract_cells), for the 16
    `render_scals` of render_scals_for(view, cam). `slab`: shard mode (the
    module docstring); `config` is then the slab's (bucketed.slab_config).
    The whole host path runs in the span `mpm.kernel.g2p`."""
    global launches, emit_launches, shard_launches
    if emit_splats and render_scals is None:
        raise ValueError("emit_splats needs render_scals (render_scals_for(view, cam))")
    dev = state.pos.device
    if dev.type == "cpu":
        out = g2p_migrate_plain(state, grid, config, fp, interactions, slab)
        if emit_splats:
            return out, cell_splats_plain(out.pos, out.vel, out.mass, render_scals)
        return out
    if dev.type != "cuda":
        raise ValueError(f"kernel F runs on CUDA devices, not {dev}")
    check_supported(config)
    check_state(state, config)
    gvel = grid.mom
    gt = torch.int32 if config.fixed_point else torch.float32
    gc = config.num_cells // config.grid_res[0] * (config.grid_res[0] + 2 * slab.go)
    if (tuple(gvel.shape) != (3, gc) or gvel.dtype != gt
            or gvel.device != dev or not gvel.is_contiguous()):
        raise ValueError(f"grid.mom must be a contiguous {gt} [3, {gc}] tensor on {dev}")

    # a: G2P's pos, vel and C, and the migration's scratch index row; b: the
    # result; codes: the migration's two rows of slot codes
    a = (torch.empty_like(state.pos), torch.empty_like(state.vel),
         torch.empty_like(state.C), torch.empty_like(state.ids))
    b = (torch.empty_like(state.pos), torch.empty_like(state.vel),
         torch.empty_like(state.C), torch.empty_like(state.mass),
         torch.empty_like(state.ids))
    codes = torch.empty((2, *state.mass.shape), dtype=torch.uint8, device=dev)
    cnt = torch.stack([state.lost, state.cfl_clamped, state.deferred,
                       state.ceiling]).to(torch.int32)
    inter = interaction_rows(interactions, 3, dev)
    params = _params(config, fp, inter, len(interactions), slab)
    splats = (torch.empty((5, config.num_cells), dtype=torch.float32, device=dev)
              if emit_splats else None)
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.g2p_migrate(
            ctypes.byref(params), P(state.pos), P(state.vel), P(state.C),
            P(state.mass), P(state.ids), P(gvel), *[P(t) for t in a],
            *[P(t) for t in b], P(codes), P(cnt),
            int(config.vc_dtype == torch.bfloat16), int(config.fixed_point),
            scals_arg(render_scals) if emit_splats else None,
            P(splats) if emit_splats else None, build.stream_of(dev))
    build.check_rc("g2p_migrate", rc)
    launches += 1
    emit_launches += int(emit_splats)
    shard_launches += int(slab != WHOLE)
    pos, vel, C, mass, ids = b
    out = BucketState(pos=pos, vel=vel, C=C, mass=mass, ids=ids, lost=cnt[0],
                      cfl_clamped=cnt[1], deferred=cnt[2], ceiling=cnt[3])
    return (out, splats) if emit_splats else out
