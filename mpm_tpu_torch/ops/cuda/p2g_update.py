"""Kernel P: P2G, density, EOS / viscous force and grid update in one
hand-written CUDA kernel chain (csrc/p2g_update.cu), beside its plain
PyTorch version.

`p2g_update(state, config, fp)` takes the plain version for a state on the
CPU and launches the kernel for a state on a CUDA device; there is no other
fallback. Both return Grid(mom=grid velocity [3, C], mass=grid mass [C]):
float32, or int32 for a fixed-point config (ops/fixed_point.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.params import BC_FRICTION, BC_SLIP, BC_STICK, FluidParams, SimConfig
from ...core.state import Grid
from ...utils.timing import spanned
from ..bucketed import BucketState, p2g_bucketed
from ..grid import update_grid
from . import build

launches = 0  # kernel launches by p2g_update (plain-version calls not counted)

_BC = {BC_SLIP: 0, BC_STICK: 1, BC_FRICTION: 2}


class P2GParams(ctypes.Structure):
    """Mirror of P2GParams in csrc/p2g_params.cuh."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("K", ctypes.c_int), ("C", ctypes.c_int),
        ("dres", ctypes.c_int * 3),
        ("bc", ctypes.c_int), ("band_lo", ctypes.c_int), ("band_hi", ctypes.c_int),
        ("eos_pow_n", ctypes.c_int), ("legacy_strain", ctypes.c_int),
        ("eos_pow_f", ctypes.c_float), ("dt", ctypes.c_float),
        ("gravity", ctypes.c_float * 3), ("rest_density", ctypes.c_float),
        ("mu", ctypes.c_float), ("eos_k", ctypes.c_float),
        ("pressure_floor", ctypes.c_float), ("friction", ctypes.c_float),
        ("fixed_mult", ctypes.c_float),
    ]


def p2g_update_plain(state: BucketState, config: SimConfig, fp: FluidParams) -> Grid:
    """The plain PyTorch version: bucketed.p2g_bucketed + grid.update_grid."""
    return update_grid(p2g_bucketed(state, config, fp), config, fp)


def check_supported(config: SimConfig) -> None:
    """Raise for configs kernels P and F do not cover."""
    if config.dim != 3:
        raise NotImplementedError(
            "kernels P and F are 3D; 2D configs take ops/cuda/substep2d")
    check_grid(config)


def check_grid(config: SimConfig) -> None:
    """Raise for configs no bucket kernel covers, 3D or 2D."""
    if config.bc not in _BC:
        raise ValueError(f"unknown bc flavor: {config.bc}")
    if config.clamp_lo < 1.0 or config.clamp_hi_offset <= 1.0:
        # the kernels bound neighbour reads by grid coordinates; the plain
        # version reads flat offsets that wrap rows. They agree only while
        # the clamps keep each axis's edge planes empty, the invariant the
        # JAX package's engines and kernels assume (mpm_tpu/ops/bucketed.py:16-19).
        raise NotImplementedError(
            "clamp_lo < 1 or clamp_hi_offset <= 1 lets particles into the "
            "grid's edge planes, which the bucket kernels assume empty; "
            "mode='bucketed' runs such a config")


def check_state(state: BucketState, config: SimConfig) -> None:
    d, k, c = config.dim, config.bin_capacity, config.num_cells
    want = {
        "pos": ((d, k, c), torch.float32),
        "vel": ((d, k, c), config.vc_dtype),
        "C": ((d, d, k, c), config.vc_dtype),
        "mass": ((k, c), torch.float32),
        "ids": ((k, c), torch.int32),
    }
    dev = state.pos.device
    for name, (shape, dtype) in want.items():
        t = getattr(state, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"state.{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous on {dev}")


def params_for(config: SimConfig, fp: FluidParams) -> P2GParams:
    """The parameter block of kernel P and of the per-pass kernels."""
    p = P2GParams()
    p.nx, p.ny, p.nz = config.grid_res
    p.K, p.C = config.bin_capacity, config.num_cells
    p.dres[:] = list(config.dres)
    p.bc = _BC[config.bc]
    p.band_lo, p.band_hi = config.bc_band_lo, config.bc_band_hi
    ps = float(config.eos_power_static)
    p.eos_pow_n = int(ps) if ps.is_integer() and 0 < ps <= 32 else 0
    p.eos_pow_f = ps if ps else float(fp.eos_power)
    p.legacy_strain = int(config.legacy_strain)
    p.dt = float(fp.dt)
    p.gravity[:] = [float(v) for v in fp.gravity.tolist()]
    p.rest_density = float(fp.rest_density)
    p.mu = float(fp.dynamic_viscosity)
    p.eos_k = float(fp.eos_stiffness)
    p.pressure_floor = float(fp.pressure_floor)
    p.friction = config.friction
    p.fixed_mult = config.fixed_point_mult
    return p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("p2g_update")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.p2g_update.argtypes = [vp] * 10 + [ci, ci, vp]
    lib.p2g_update.restype = ci
    lib.p2g_update_params_size.argtypes = []
    lib.p2g_update_params_size.restype = ci
    if lib.p2g_update_params_size() != ctypes.sizeof(P2GParams):
        raise RuntimeError("P2GParams layout differs between csrc and Python")
    return lib


@spanned("mpm.kernel.p2g")
def p2g_update(state: BucketState, config: SimConfig, fp: FluidParams) -> Grid:
    """P2G + grid update: the plain version on the CPU, kernel P on CUDA;
    the whole host path in the span `mpm.kernel.p2g`."""
    global launches
    dev = state.pos.device
    if dev.type == "cpu":
        return p2g_update_plain(state, config, fp)
    if dev.type != "cuda":
        raise ValueError(f"kernel P runs on CUDA devices, not {dev}")
    check_supported(config)
    check_state(state, config)
    k, c = config.bin_capacity, config.num_cells

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    gt = torch.int32 if config.fixed_point else torch.float32
    gmass, gmom, gvel = empty(c, dtype=gt), empty(3, c, dtype=gt), empty(3, c, dtype=gt)
    a_p, b_mu = empty(k, c), empty(k, c)
    params = params_for(config, fp)
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.p2g_update(
            ctypes.byref(params), P(state.pos), P(state.vel), P(state.C),
            P(state.mass), P(gmass), P(gmom), P(a_p), P(b_mu), P(gvel),
            int(config.vc_dtype == torch.bfloat16), int(config.fixed_point),
            build.stream_of(dev))
    build.check_rc("p2g_update", rc)
    launches += 1
    return Grid(mom=gvel, mass=gmass)
