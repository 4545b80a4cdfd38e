"""The two sharded stages of kernel P (csrc/p2g_shard.cu), beside their
plain PyTorch versions, on one slab of an x-slab decomposition
(parallel/domain.py).

`padded` is a slab padded with its neighbours' two nearest planes a side:
L planes from global plane `x0`, under the slab's config
(bucketed.slab_config(config, L)). Its grid has one plane more on each
side, L + 2 planes from global plane x0 - 1.

    g1 = p2g1_shard(padded, config, fp, x0)
        -> Grid(mom=pass-1 momentum [3, (L+2)*pc], mass=grid mass [(L+2)*pc]),
           exact on grid planes [2, L-1]
    gvel = p2g2u_shard(padded, Grid(mom=g1.mom, mass=exchanged mass), config, fp, x0)
        -> grid velocity [3, (L+2)*pc], exact on grid planes [2, L-1]

float32 grids, or int32 for a fixed-point config. Each wrapper takes its
plain version for a tensor on the CPU and launches its kernel for a tensor
on a CUDA device; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.params import FluidParams, SimConfig
from ...core.state import Grid
from ...utils.timing import spanned
from ..bucketed import BucketState, Slab, force_coefs, p2g_pass1, p2g_pass2, slab_config
from ..grid import update_grid
from . import build
from .p2g_update import P2GParams, check_state, check_supported, params_for

p2g1_launches = 0  # kernel launches of p2g1_shard (plain-version calls not counted)
p2g2u_launches = 0  # kernel launches of p2g2u_shard


def _slab(x0: int) -> Slab:
    return Slab(x0=x0, go=1)


def p2g1_shard_plain(padded: BucketState, config: SimConfig, fp: FluidParams,
                     x0: int) -> Grid:
    """Stage 1's plain version: bucketed.p2g_pass1 on the slab's grid."""
    return p2g_pass1(padded, config, _slab(x0))


def p2g2u_shard_plain(padded: BucketState, grid1: Grid, config: SimConfig,
                      fp: FluidParams, x0: int) -> torch.Tensor:
    """Stage 2's plain version: the force coefficients from grid1.mass,
    pass 2 added to grid1.mom, and the grid update of every grid plane."""
    slab = _slab(x0)
    a_p, b_mu = force_coefs(padded, grid1.mass, config, fp, slab)
    mom = p2g_pass2(padded, a_p, b_mu, grid1.mom, config, slab)
    wide = slab_config(config, config.grid_res[0] + 2)
    return update_grid(Grid(mom=mom, mass=grid1.mass), wide, fp, x0=x0 - 1).mom


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("p2g_shard")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.p2g1_shard.argtypes = [vp, ci] + [vp] * 6 + [ci, ci, vp]
    lib.p2g1_shard.restype = ci
    lib.p2g2u_shard.argtypes = [vp, ci] + [vp] * 8 + [ci, ci, vp]
    lib.p2g2u_shard.restype = ci
    lib.p2g_shard_params_size.argtypes = []
    lib.p2g_shard_params_size.restype = ci
    if lib.p2g_shard_params_size() != ctypes.sizeof(P2GParams):
        raise RuntimeError("P2GParams layout differs between csrc and Python")
    return lib


def _check(padded: BucketState, config: SimConfig) -> torch.device:
    dev = padded.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the sharded kernel P stages run on CUDA devices, not {dev}")
    check_supported(config)
    check_state(padded, config)
    return dev


def _grid_dtype(config: SimConfig) -> torch.dtype:
    return torch.int32 if config.fixed_point else torch.float32


@spanned("mpm.kernel.p2g_shard")
def p2g1_shard(padded: BucketState, config: SimConfig, fp: FluidParams, x0: int) -> Grid:
    """Stage 1: the plain version on the CPU, the kernel on CUDA (the whole
    host path in the span `mpm.kernel.p2g_shard`)."""
    global p2g1_launches
    if padded.pos.device.type == "cpu":
        return p2g1_shard_plain(padded, config, fp, x0)
    dev = _check(padded, config)
    gc = config.num_cells // config.grid_res[0] * (config.grid_res[0] + 2)
    gt = _grid_dtype(config)
    gmass = torch.empty((gc,), dtype=gt, device=dev)
    gmom = torch.empty((3, gc), dtype=gt, device=dev)
    params = params_for(config, fp)
    P = build.ptr
    with torch.cuda.device(dev):
        rc = _lib().p2g1_shard(
            ctypes.byref(params), x0, P(padded.pos), P(padded.vel), P(padded.C),
            P(padded.mass), P(gmass), P(gmom), int(config.vc_dtype == torch.bfloat16),
            int(config.fixed_point), build.stream_of(dev))
    build.check_rc("p2g1_shard", rc)
    p2g1_launches += 1
    return Grid(mom=gmom, mass=gmass)


@spanned("mpm.kernel.p2g_shard")
def p2g2u_shard(padded: BucketState, grid1: Grid, config: SimConfig, fp: FluidParams,
                x0: int) -> torch.Tensor:
    """Stage 2: the plain version on the CPU, the kernel on CUDA (the whole
    host path in the span `mpm.kernel.p2g_shard`)."""
    global p2g2u_launches
    if padded.pos.device.type == "cpu":
        return p2g2u_shard_plain(padded, grid1, config, fp, x0)
    dev = _check(padded, config)
    k, c = config.bin_capacity, config.num_cells
    gc = c // config.grid_res[0] * (config.grid_res[0] + 2)
    gt = _grid_dtype(config)
    for name, t, shape in (("mass", grid1.mass, (gc,)), ("mom", grid1.mom, (3, gc))):
        if (tuple(t.shape) != shape or t.dtype != gt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"grid1.{name} must be a contiguous {gt} {list(shape)} tensor "
                             f"on {dev}")
    a_p = torch.empty((k, c), dtype=torch.float32, device=dev)
    b_mu = torch.empty((k, c), dtype=torch.float32, device=dev)
    gvel = torch.empty((3, gc), dtype=gt, device=dev)
    params = params_for(config, fp)
    P = build.ptr
    with torch.cuda.device(dev):
        rc = _lib().p2g2u_shard(
            ctypes.byref(params), x0, P(padded.pos), P(padded.C), P(padded.mass),
            P(grid1.mass), P(grid1.mom), P(a_p), P(b_mu), P(gvel),
            int(config.vc_dtype == torch.bfloat16), int(config.fixed_point),
            build.stream_of(dev))
    build.check_rc("p2g2u_shard", rc)
    p2g2u_launches += 1
    return gvel
