"""The 2D substep in two hand-written CUDA kernel chains (csrc/substep2d.cu),
beside their plain PyTorch versions: the port of
``mpm_tpu.ops.pallas.kernels2d``.

- `sim2d(state, config, fp, interactions)`: P2G (both passes), the grid
  update, G2P and the advection tail, returning the state before migration
  with `cfl_clamped` counted (the TPU's `_sim2d_kernel`).
- `migrate2d(state, config)`: both axis-split migration phases, axis 1 then
  axis 0, with overflow rejection (`_migrate2d_kernel`).
- `substep2d`: one after the other.

Each wrapper takes its plain version for a state on the CPU and launches
its kernel for a state on a CUDA device; there is no other fallback. vel
and C are stored as float32 or bf16; fixed-point 2D configs raise (the JAX
package's `supported2d` refuses them too, and ops/cuda/step.route sends
them to the plain engine).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ..bucketed import BucketState, g2p_bucketed, migrate, p2g_bucketed
from ..grid import update_grid
from ..interact import Interaction, interaction_rows
from . import build
from .p2g_update import _BC, check_grid, check_state

sim2d_launches = 0  # kernel launches by sim2d (plain-version calls not counted)
migrate2d_launches = 0  # kernel launches by migrate2d


class Sim2DParams(ctypes.Structure):
    """Mirror of Sim2DParams in csrc/substep2d.cu."""

    _fields_ = [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("K", ctypes.c_int), ("C", ctypes.c_int),
        ("dres", ctypes.c_int * 2),
        ("bc", ctypes.c_int), ("band_lo", ctypes.c_int), ("band_hi", ctypes.c_int),
        ("eos_pow_n", ctypes.c_int), ("legacy_strain", ctypes.c_int), ("n_inter", ctypes.c_int),
        ("eos_pow_f", ctypes.c_float), ("dt", ctypes.c_float),
        ("gravity", ctypes.c_float * 2), ("rest_density", ctypes.c_float),
        ("mu", ctypes.c_float), ("eos_k", ctypes.c_float),
        ("pressure_floor", ctypes.c_float), ("friction", ctypes.c_float),
        ("clamp_lo", ctypes.c_float), ("clamp_hi_offset", ctypes.c_float),
        ("wall_min", ctypes.c_float), ("wall_max_offset", ctypes.c_float),
        ("wall_stiffness", ctypes.c_float),
        ("inter", ctypes.c_void_p),
    ]


def sim2d_plain(state: BucketState, config: SimConfig, fp: FluidParams,
                interactions: Sequence[Interaction] = ()) -> BucketState:
    """The plain PyTorch version: bucketed.p2g_bucketed, grid.update_grid,
    bucketed.g2p_bucketed."""
    grid = update_grid(p2g_bucketed(state, config, fp), config, fp)
    return g2p_bucketed(state, grid, config, fp, interactions)


def migrate2d_plain(state: BucketState, config: SimConfig) -> BucketState:
    """The plain PyTorch version: bucketed.migrate (axis 1, then axis 0)."""
    return migrate(state, config)


def check_supported2d(config: SimConfig) -> None:
    """Raise for configs the 2D kernels do not cover."""
    if config.dim != 2:
        raise NotImplementedError("sim2d and migrate2d are 2D; 3D configs take "
                                  "kernels P and F")
    check_grid(config)
    if config.fixed_point:
        raise NotImplementedError(
            "the 2D kernels take float grids: kernels2d.supported2d refuses "
            'fixed-point 2D configs too, and mode="cuda" runs them on the plain engine')
    if config.domain_res is not None and config.domain_res != config.grid_res:
        raise NotImplementedError("the air window is 3D; a 2D config has no "
                                  "domain_res of its own")


def _params(config: SimConfig, fp: FluidParams, inter: torch.Tensor | None,
            n_inter: int) -> Sim2DParams:
    p = Sim2DParams()
    p.nx, p.ny = config.grid_res
    p.K, p.C = config.bin_capacity, config.num_cells
    p.dres[:] = list(config.dres)
    p.bc = _BC[config.bc]
    p.band_lo, p.band_hi = config.bc_band_lo, config.bc_band_hi
    ps = float(config.eos_power_static)
    p.eos_pow_n = int(ps) if ps.is_integer() and 0 < ps <= 32 else 0
    p.eos_pow_f = ps if ps else float(fp.eos_power)
    p.legacy_strain = int(config.legacy_strain)
    p.n_inter = n_inter
    p.dt = float(fp.dt)
    p.gravity[:] = [float(v) for v in fp.gravity.tolist()]
    p.rest_density = float(fp.rest_density)
    p.mu = float(fp.dynamic_viscosity)
    p.eos_k = float(fp.eos_stiffness)
    p.pressure_floor = float(fp.pressure_floor)
    p.friction = config.friction
    p.clamp_lo, p.clamp_hi_offset = config.clamp_lo, config.clamp_hi_offset
    p.wall_min, p.wall_max_offset = config.wall_min, config.wall_max_offset
    p.wall_stiffness = config.wall_stiffness
    p.inter = None if inter is None else inter.data_ptr()
    return p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("substep2d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sim2d.argtypes = [vp] * 14 + [ci, vp]
    lib.sim2d.restype = ci
    lib.migrate2d.argtypes = [ci] * 3 + [vp] * 17 + [ci, vp]
    lib.migrate2d.restype = ci
    lib.substep2d_params_size.argtypes = []
    lib.substep2d_params_size.restype = ci
    if lib.substep2d_params_size() != ctypes.sizeof(Sim2DParams):
        raise RuntimeError("Sim2DParams layout differs between csrc and Python")
    return lib


def _device_of(state: BucketState, what: str) -> torch.device | None:
    """None for a state on the CPU (the plain version runs), the device for
    a state on CUDA; raise for any other device."""
    dev = state.pos.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA devices, not {dev}")
    return dev


def sim2d(state: BucketState, config: SimConfig, fp: FluidParams,
          interactions: Sequence[Interaction] = ()) -> BucketState:
    """P2G, grid update, G2P and tail: the plain version on the CPU, the
    sim2d kernel chain on CUDA. mass and ids pass through unchanged."""
    global sim2d_launches
    dev = _device_of(state, "sim2d")
    if dev is None:
        return sim2d_plain(state, config, fp, interactions)
    check_supported2d(config)
    check_state(state, config)
    k, c = config.bin_capacity, config.num_cells
    inter = interaction_rows(interactions, 2, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    gmass, gmom, gvel = empty(c), empty(2, c), empty(2, c)
    a_p, b_mu = empty(k, c), empty(k, c)
    pos, vel, C = (torch.empty_like(state.pos), torch.empty_like(state.vel),
                   torch.empty_like(state.C))
    cfl = state.cfl_clamped.to(torch.int32).reshape(1).clone()
    params = _params(config, fp, inter, len(interactions))
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.sim2d(ctypes.byref(params), P(state.pos), P(state.vel), P(state.C),
                       P(state.mass), P(gmass), P(gmom), P(a_p), P(b_mu), P(gvel), P(pos),
                       P(vel), P(C), P(cfl), int(config.vc_dtype == torch.bfloat16),
                       build.stream_of(dev))
    build.check_rc("sim2d", rc)
    sim2d_launches += 1
    return state.replace(pos=pos, vel=vel, C=C, cfl_clamped=cfl[0])


def migrate2d(state: BucketState, config: SimConfig) -> BucketState:
    """Both migration phases: the plain version on the CPU, the migrate2d
    kernel chain on CUDA."""
    global migrate2d_launches
    dev = _device_of(state, "migrate2d")
    if dev is None:
        return migrate2d_plain(state, config)
    check_supported2d(config)
    check_state(state, config)

    def new_state():
        return (torch.empty_like(state.pos), torch.empty_like(state.vel),
                torch.empty_like(state.C), torch.empty_like(state.mass),
                torch.empty_like(state.ids))

    a, b = new_state(), new_state()
    R = torch.empty_like(state.mass)
    cnt = torch.stack([state.lost, state.deferred]).to(torch.int32)
    nx, ny = config.grid_res
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.migrate2d(nx, ny, config.bin_capacity, P(state.pos), P(state.vel), P(state.C),
                           P(state.mass), P(state.ids), *[P(t) for t in a],
                           *[P(t) for t in b], P(R), P(cnt),
                           int(config.vc_dtype == torch.bfloat16), build.stream_of(dev))
    build.check_rc("migrate2d", rc)
    migrate2d_launches += 1
    pos, vel, C, mass, ids = b
    return state.replace(pos=pos, vel=vel, C=C, mass=mass, ids=ids, lost=cnt[0],
                         deferred=cnt[1])


def substep2d(state: BucketState, config: SimConfig, fp: FluidParams,
              interactions: Sequence[Interaction] = ()) -> BucketState:
    """One 2D substep: sim2d then migrate2d (kernels2d.substep2d)."""
    return migrate2d(sim2d(state, config, fp, interactions), config)
