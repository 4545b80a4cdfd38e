"""Kernel F: G2P, the advection tail and 3-axis bucket migration in one
hand-written CUDA kernel chain (csrc/g2p_migrate.cu), beside its plain
PyTorch version, with the optional per-cell splat emission of the render
path.

`g2p_migrate(state, grid, config, fp, interactions)` takes the plain
version for a state on the CPU and launches the kernel for a state on a
CUDA device; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ...core.state import Grid
from ..bucketed import BucketState, g2p_bucketed, migrate
from ..interact import Interaction
from . import build
from .extract_cells import cell_splats_plain, render_scals_for, scals_arg
from .p2g_update import check_state, check_supported

__all__ = ["g2p_migrate", "g2p_migrate_plain", "render_scals_for"]

launches = 0  # kernel launches by g2p_migrate (plain-version calls not counted)
emit_launches = 0  # of those, launches that emitted splats

MAX_INTER = 8  # csrc/g2p_migrate.cu MAX_INTER
_INTER_VALS = 7


class G2PParams(ctypes.Structure):
    """Mirror of G2PParams in csrc/g2p_migrate.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("K", ctypes.c_int), ("C", ctypes.c_int),
        ("dres", ctypes.c_int * 3),
        ("n_inter", ctypes.c_int), ("ceil_band_y", ctypes.c_int),
        ("dt", ctypes.c_float),
        ("clamp_lo", ctypes.c_float), ("clamp_hi_offset", ctypes.c_float),
        ("wall_min", ctypes.c_float), ("wall_max_offset", ctypes.c_float),
        ("wall_stiffness", ctypes.c_float),
        ("inter", ctypes.c_float * (MAX_INTER * _INTER_VALS)),
    ]


def g2p_migrate_plain(state: BucketState, grid: Grid, config: SimConfig,
                      fp: FluidParams,
                      interactions: Sequence[Interaction] = ()) -> BucketState:
    """The plain PyTorch version: bucketed.g2p_bucketed + bucketed.migrate."""
    return migrate(g2p_bucketed(state, grid, config, fp, interactions), config)


def ceiling_band_y(config: SimConfig) -> int:
    """First y cell of the air-window ceiling band, or -1 when the config is
    not y-windowed (bucketed.reject_overflow)."""
    if config.domain_res is not None and config.grid_res[1] < config.domain_res[1]:
        return config.grid_res[1] - 4
    return -1


def _params(config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction]) -> G2PParams:
    if len(interactions) > MAX_INTER:
        raise ValueError(f"kernel F takes at most {MAX_INTER} interactions")
    p = G2PParams()
    p.nx, p.ny, p.nz = config.grid_res
    p.K, p.C = config.bin_capacity, config.num_cells
    p.dres[:] = list(config.dres)
    p.n_inter = len(interactions)
    p.ceil_band_y = ceiling_band_y(config)
    p.dt = float(fp.dt)
    p.clamp_lo, p.clamp_hi_offset = config.clamp_lo, config.clamp_hi_offset
    p.wall_min, p.wall_max_offset = config.wall_min, config.wall_max_offset
    p.wall_stiffness = config.wall_stiffness
    vals = [v for it in interactions for v in it.values()]
    p.inter[: len(vals)] = vals
    return p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("g2p_migrate")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.g2p_migrate.argtypes = [vp] * 19 + [ci, vp, vp, vp]
    lib.g2p_migrate.restype = ci
    lib.g2p_migrate_params_size.argtypes = []
    lib.g2p_migrate_params_size.restype = ci
    lib.g2p_migrate_max_interactions.argtypes = []
    lib.g2p_migrate_max_interactions.restype = ci
    if (lib.g2p_migrate_params_size() != ctypes.sizeof(G2PParams)
            or lib.g2p_migrate_max_interactions() != MAX_INTER):
        raise RuntimeError("G2PParams layout differs between csrc and Python")
    return lib


def g2p_migrate(state: BucketState, grid: Grid, config: SimConfig,
                fp: FluidParams, interactions: Sequence[Interaction] = (),
                emit_splats: bool = False, render_scals: torch.Tensor | None = None):
    """G2P + tail + migration: the plain version on the CPU, kernel F on CUDA.

    With emit_splats=True it returns (state, splats): splats [5, C] are the
    per-cell splat points of the result (ops/cuda/extract_cells), for the 16
    `render_scals` of render_scals_for(view, cam)."""
    global launches, emit_launches
    if emit_splats and render_scals is None:
        raise ValueError("emit_splats needs render_scals (render_scals_for(view, cam))")
    dev = state.pos.device
    if dev.type == "cpu":
        out = g2p_migrate_plain(state, grid, config, fp, interactions)
        if emit_splats:
            return out, cell_splats_plain(out.pos, out.vel, out.mass, render_scals)
        return out
    if dev.type != "cuda":
        raise ValueError(f"kernel F runs on CUDA devices, not {dev}")
    check_supported(config)
    check_state(state, config)
    gvel = grid.mom
    if (tuple(gvel.shape) != (3, config.num_cells) or gvel.dtype != torch.float32
            or gvel.device != dev or not gvel.is_contiguous()):
        raise ValueError("grid.mom must be a contiguous float32 [3, C] tensor "
                         f"on {dev}")

    def new_state():
        return (torch.empty_like(state.pos), torch.empty_like(state.vel),
                torch.empty_like(state.C), torch.empty_like(state.mass),
                torch.empty_like(state.ids))

    a, b = new_state(), new_state()
    R = torch.empty_like(state.mass)
    cnt = torch.stack([state.lost, state.cfl_clamped, state.deferred,
                       state.ceiling]).to(torch.int32)
    params = _params(config, fp, interactions)
    splats = (torch.empty((5, config.num_cells), dtype=torch.float32, device=dev)
              if emit_splats else None)
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.g2p_migrate(
            ctypes.byref(params), P(state.pos), P(state.vel), P(state.C),
            P(state.mass), P(state.ids), P(gvel), *[P(t) for t in a],
            *[P(t) for t in b], P(R), P(cnt),
            int(config.vc_dtype == torch.bfloat16),
            scals_arg(render_scals) if emit_splats else None,
            P(splats) if emit_splats else None, build.stream_of(dev))
    build.check_rc("g2p_migrate", rc)
    launches += 1
    emit_launches += int(emit_splats)
    pos, vel, C, mass, ids = b
    out = BucketState(pos=pos, vel=vel, C=C, mass=mass, ids=ids, lost=cnt[0],
                      cfl_clamped=cnt[1], deferred=cnt[2], ceiling=cnt[3])
    return (out, splats) if emit_splats else out
