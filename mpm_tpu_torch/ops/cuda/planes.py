"""The per-pass substep: kernels A, B and D in hand-written CUDA
(csrc/planes.cu), each beside its plain PyTorch version, the grid update and
the advection tail in plain PyTorch, and migration kernel E
(ops/cuda/migrate_planes.py). The port of mpm_tpu/ops/pallas/
bucket_kernels.py, which the JAX package runs under MPM_PALLAS_OLD=1
(ops/cuda/step.resolve).

    A  p2g1_planes: P2G pass 1, grid mass and APIC momentum.
    B  p2g2_planes: the density gather, EOS and viscosity, and pass 2's force
       momentum from zero.
    D  g2p_planes: the G2P velocity gather and C = 4B, zero at empty slots.

Every wrapper takes its plain version for a state on the CPU and launches
its kernel for a state on a CUDA device; there is no other fallback. The
kernels take what the JAX kernels take (bucket_kernels.pallas_supported):
3D, float32 storage, float grids; `substep` runs any other config on the
plain engine, as bucket_kernels.substep does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ...core.state import Grid
from .. import bucketed
from ..bucketed import (BucketState, advect_tail, force_coefs, g2p_gather, p2g_pass1,
                        p2g_pass2)
from ..grid import update_grid
from ..interact import Interaction
from . import build
from .migrate_planes import check_planes, migrate_planes, migrate_planes_plain
from .p2g_update import P2GParams, check_state, params_for

p2g1_launches = 0  # kernel A launches by p2g1_planes (plain-version calls not counted)
p2g2_launches = 0  # kernel B launches by p2g2_planes
g2p_launches = 0  # kernel D launches by g2p_planes


# ---------------------------------------------------------- plain versions


def p2g1_plain(state: BucketState, config: SimConfig) -> Grid:
    """Kernel A's plain version: bucketed.p2g_pass1."""
    return p2g_pass1(state, config)


def p2g2_plain(state: BucketState, gmass: torch.Tensor, config: SimConfig,
               fp: FluidParams) -> torch.Tensor:
    """Kernel B's plain version: the force coefficients from the pass-1
    grid mass, then pass 2 from zero."""
    a_p, b_mu = force_coefs(state, gmass, config, fp)
    return p2g_pass2(state, a_p, b_mu, torch.zeros_like(state.pos[:, 0]), config)


def g2p_plain(state: BucketState, grid: Grid,
              config: SimConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's plain version: bucketed.g2p_gather, zeroed at empty slots."""
    vel, Cmat = g2p_gather(state, grid, config)
    occ = state.mass > 0
    return torch.where(occ, vel, 0.0), torch.where(occ, Cmat, 0.0)


# ---------------------------------------------------------------- kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("planes")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, n in (("p2g1_planes", 8), ("p2g2_planes", 9), ("g2p_planes", 7)):
        getattr(lib, name).argtypes = [vp] * n
        getattr(lib, name).restype = ci
    lib.planes_params_size.argtypes = []
    lib.planes_params_size.restype = ci
    if lib.planes_params_size() != ctypes.sizeof(P2GParams):
        raise RuntimeError("P2GParams layout differs between csrc and Python")
    return lib


def _geom_params(config: SimConfig) -> P2GParams:
    """A parameter block holding the grid alone: kernels A and D read no
    other field."""
    p = P2GParams()
    p.nx, p.ny, p.nz = config.grid_res
    p.K, p.C = config.bin_capacity, config.num_cells
    return p


def _on_card(state: BucketState, config: SimConfig, kname: str) -> bool:
    """False for a state on the CPU (the plain version runs); True after the
    checks for one on a CUDA device; raises for any other device."""
    dev = state.pos.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernel {kname} runs on CUDA devices, not {dev}")
    check_planes(config)
    check_state(state, config)
    return True


def _grid_arg(t: torch.Tensor, shape: tuple, dev) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"want a float32 {shape} grid on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def p2g1_planes(state: BucketState, config: SimConfig) -> Grid:
    """Kernel A: Grid(mom=pass-1 momentum [3, C], mass=grid mass [C])."""
    global p2g1_launches
    if not _on_card(state, config, "A"):
        return p2g1_plain(state, config)
    dev, c = state.pos.device, config.num_cells
    gmass = torch.empty(c, dtype=torch.float32, device=dev)
    gmom = torch.empty((3, c), dtype=torch.float32, device=dev)
    P = build.ptr
    params = _geom_params(config)
    with torch.cuda.device(dev):
        rc = _lib().p2g1_planes(ctypes.byref(params), P(state.pos), P(state.vel),
                                P(state.C), P(state.mass), P(gmass), P(gmom),
                                build.stream_of(dev))
    build.check_rc("p2g1_planes", rc)
    p2g1_launches += 1
    return Grid(mom=gmom, mass=gmass)


def p2g2_planes(state: BucketState, gmass: torch.Tensor, config: SimConfig,
                fp: FluidParams) -> torch.Tensor:
    """Kernel B: the pass-2 force momentum [3, C] from zero, from kernel A's
    grid mass."""
    global p2g2_launches
    if not _on_card(state, config, "B"):
        return p2g2_plain(state, gmass, config, fp)
    dev, k, c = state.pos.device, config.bin_capacity, config.num_cells
    gmass = _grid_arg(gmass, (c,), dev)
    a_p = torch.empty((k, c), dtype=torch.float32, device=dev)
    b_mu = torch.empty((k, c), dtype=torch.float32, device=dev)
    gmom2 = torch.empty((3, c), dtype=torch.float32, device=dev)
    P = build.ptr
    params = params_for(config, fp)
    with torch.cuda.device(dev):
        rc = _lib().p2g2_planes(ctypes.byref(params), P(state.pos), P(state.C),
                                P(state.mass), P(gmass), P(a_p), P(b_mu), P(gmom2),
                                build.stream_of(dev))
    build.check_rc("p2g2_planes", rc)
    p2g2_launches += 1
    return gmom2


def g2p_planes(state: BucketState, grid: Grid,
               config: SimConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (vel [3, K, C], C [3, 3, K, C]) from the grid velocity
    grid.mom, zero at empty slots."""
    global g2p_launches
    if not _on_card(state, config, "D"):
        return g2p_plain(state, grid, config)
    dev = state.pos.device
    gvel = _grid_arg(grid.mom, (3, config.num_cells), dev)
    vel = torch.empty_like(state.vel)
    Cm = torch.empty_like(state.C)
    P = build.ptr
    params = _geom_params(config)
    with torch.cuda.device(dev):
        rc = _lib().g2p_planes(ctypes.byref(params), P(state.pos), P(state.mass), P(gvel),
                               P(vel), P(Cm), build.stream_of(dev))
    build.check_rc("g2p_planes", rc)
    g2p_launches += 1
    return vel, Cm


# ---------------------------------------------------------------- substep


def _p2g(state, config, fp, p2g1, p2g2) -> Grid:
    g1 = p2g1(state, config)
    return Grid(mom=g1.mom + p2g2(state, g1.mass, config, fp), mass=g1.mass)


def p2g_planes(state: BucketState, config: SimConfig, fp: FluidParams) -> Grid:
    """A, then B, then gmom = gmom1 + gmom2 (bucket_kernels.py:382-386)."""
    return _p2g(state, config, fp, p2g1_planes, p2g2_planes)


def _per_pass(state, config, fp, interactions, p2g1, p2g2, g2p, migrate_fn):
    """bucket_kernels.substep through the given A, B, D and E: the grid
    update (plain, as the JAX package leaves it to XLA) after B, the
    advection tail (plain, bucketed.advect_tail) after D."""
    grid = update_grid(_p2g(state, config, fp, p2g1, p2g2), config, fp)
    vel, Cm = g2p(state, grid, config)
    return migrate_fn(advect_tail(state, vel, Cm, config, fp, interactions), config)


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    """The per-pass substep: kernels A, B, D and E (their plain versions
    for a state on the CPU). A config outside their envelope (2D, fixed
    point, bf16 storage; ops/cuda/step.route) runs the plain engine, as
    bucket_kernels.substep sends it to the XLA engine; a windowed config
    raises (check_planes)."""
    from .step import route

    if route(config, per_pass=True) == "plain":
        return bucketed.substep(state, config, fp, interactions)
    check_planes(config)
    return _per_pass(state, config, fp, interactions, p2g1_planes, p2g2_planes, g2p_planes,
                     migrate_planes)


def substep_plain(state: BucketState, config: SimConfig, fp: FluidParams,
                  interactions: Sequence[Interaction] = ()) -> BucketState:
    """The per-pass substep through the plain versions, on any device."""
    return _per_pass(state, config, fp, interactions, p2g1_plain, p2g2_plain, g2p_plain,
                     migrate_planes_plain)
