"""Migration kernel E: the three axis phases of bucket migration (z, y, x),
each with its overflow rejection, in hand-written CUDA (the migrate_planes
entry of csrc/planes.cu), beside its plain PyTorch version. The port of
mpm_tpu/ops/pallas/migrate_kernels.py (migrate_pallas), the per-pass
substep's last step.

`migrate_planes(state, config)` takes the plain version for a state on the
CPU and launches the kernel for a state on a CUDA device; there is no other
fallback. One select per phase moves pos, vel, C, mass and ids together and
counts `lost`; the rejection before it counts `deferred`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.params import SimConfig
from ..bucketed import BucketState, migrate
from . import build
from .p2g_update import check_grid, check_state

launches = 0  # kernel launches by migrate_planes (plain-version calls not counted)


def check_planes(config: SimConfig) -> None:
    """Raise for configs the per-pass kernels do not take."""
    if config.dim != 3 or config.fixed_point or config.vc_dtype != torch.float32:
        raise NotImplementedError(
            "the per-pass kernels (MPM_PALLAS_OLD=1) take 3D float32 configs with "
            "float grids, as the JAX package's do; mode=\"cuda\" runs bf16, fixed-point "
            "and 2D configs on the plain engine")
    if config.domain_res is not None:
        # fused.py:1173-1185: the per-pass kernels do not enforce the air
        # window's ceiling band
        raise ValueError("the per-pass kernels do not enforce the air window's ceiling "
                         "band; a windowed config (domain_res set) needs kernel F")
    check_grid(config)


def migrate_planes_plain(state: BucketState, config: SimConfig) -> BucketState:
    """The plain PyTorch version: bucketed.migrate (reject_overflow, then
    the select, for axes z, y, x)."""
    return migrate(state, config)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("planes")
    lib.migrate_planes.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 18
    lib.migrate_planes.restype = ctypes.c_int
    return lib


def migrate_planes(state: BucketState, config: SimConfig) -> BucketState:
    """Bucket migration: the plain version on the CPU, kernel E on CUDA."""
    global launches
    dev = state.pos.device
    if dev.type == "cpu":
        return migrate_planes_plain(state, config)
    if dev.type != "cuda":
        raise ValueError(f"kernel E runs on CUDA devices, not {dev}")
    check_planes(config)
    check_state(state, config)

    def new_state():
        return [torch.empty_like(t) for t in (state.pos, state.vel, state.C, state.mass,
                                              state.ids)]

    a, b = new_state(), new_state()
    R = torch.empty_like(state.mass)
    cnt = torch.stack([state.lost, state.deferred]).to(torch.int32)
    P = build.ptr
    with torch.cuda.device(dev):
        rc = _lib().migrate_planes(
            *config.grid_res, config.bin_capacity, P(state.pos), P(state.vel), P(state.C),
            P(state.mass), P(state.ids), *[P(t) for t in a], *[P(t) for t in b], P(R),
            P(cnt), build.stream_of(dev))
    build.check_rc("migrate_planes", rc)
    launches += 1
    pos, vel, C, mass, ids = a
    return state.replace(pos=pos, vel=vel, C=C, mass=mass, ids=ids, lost=cnt[0],
                         deferred=cnt[1])
