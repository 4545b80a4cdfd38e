"""mode="cuda" substep: kernel P then kernel F for a 3D config, the sim2d
and migrate2d kernels for a 2D one (the port of mpm_tpu/ops/pallas/step.py
-> fused.substep_fused), and the substep whose kernel F also emits the
render's splats (fused.substep_fused_emit). With MPM_PALLAS_OLD=1, as in
the JAX package, `resolve` gives the per-pass substep (ops/cuda/planes.py:
kernels A, B, D and E) instead. `route` sends the configs the JAX package
sends to its XLA engine to the plain engine (ops/bucketed.substep), and
raises for a config beyond the port's kernels. For a state on the CPU
every wrapper takes its plain PyTorch version."""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

from ...core.params import FluidParams, SimConfig
from .. import bucketed
from ..bucketed import BucketState
from ..interact import Interaction
from .extract_cells import cell_splats_plain
from .g2p_migrate import g2p_migrate
from .p2g_update import check_grid, p2g_update
from .planes import substep as substep_planes
from .substep2d import substep2d


def per_pass_env() -> bool:
    """MPM_PALLAS_OLD=1, read now, not at import."""
    return os.environ.get("MPM_PALLAS_OLD", "0") == "1"


def route(config: SimConfig, per_pass: bool | None = None) -> str:
    """Where mode="cuda" runs `config`: "kernel" (P and F in 3D, sim2d and
    migrate2d in 2D), "planes" (the per-pass A, B, D and E) or "plain"
    (ops/bucketed.substep). `per_pass` defaults to MPM_PALLAS_OLD=1.

    "plain" is where the JAX package runs its XLA engine (fused.py:1151-1190,
    bucket_kernels.py:271-280, 433-440): fixed-point 2D, and on the
    per-pass path every config but 3D float32 storage with a float grid.
    The kernels take any K. Clamps that let particles into the edge
    planes, which the JAX package assumes away, raise NotImplementedError
    (p2g_update.check_grid): mode="bucketed" runs such a config."""
    if per_pass is None:
        per_pass = per_pass_env()
    if per_pass:
        if config.dim != 3 or config.fixed_point or config.vc_dtype != torch.float32:
            return "plain"
        check_grid(config)
        return "planes"
    if config.dim == 2 and (config.fixed_point
                            or config.domain_res not in (None, config.grid_res)):
        return "plain"
    check_grid(config)
    return "kernel"


def resolve() -> Callable[..., BucketState]:
    """The mode="cuda" substep: the per-pass substep under MPM_PALLAS_OLD=1,
    else `substep`."""
    if per_pass_env():
        return substep_planes
    return substep


def _plain(state: BucketState, config: SimConfig, fp: FluidParams,
           interactions: Sequence[Interaction]) -> BucketState:
    """The plain engine in the kernels' place. A windowed config raises,
    as fused.py:1171-1187 does: the JAX package's fallback would not keep
    the air window's ceiling band."""
    if config.domain_res is not None:
        raise ValueError("windowed config (domain_res set) is outside the kernels' "
                         "envelope; use mode='bucketed' or a config the kernels take")
    return bucketed.substep(state, config, fp, interactions)


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    if route(config, per_pass=False) == "plain":
        return _plain(state, config, fp, interactions)
    if config.dim == 2:
        return substep2d(state, config, fp, interactions)
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions)


def substep_emit(state: BucketState, config: SimConfig, fp: FluidParams,
                 interactions: Sequence[Interaction], render_scals: torch.Tensor):
    """substep + kernel F's splat emission: (state, splats [5, C]), splats
    equal to ops/cuda/extract_cells.cell_splats_plain of the new state.
    3D only, as fused.substep_fused_emit; a config outside the kernels'
    envelope takes the plain engine and the plain emission."""
    if config.dim != 3:
        raise ValueError("substep_emit: the splat emission is 3D; 2D scenes draw "
                         "with render/render2d.py")
    if route(config, per_pass=False) == "plain":
        out = _plain(state, config, fp, interactions)
        return out, cell_splats_plain(out.pos, out.vel, out.mass, render_scals)
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions, emit_splats=True,
                       render_scals=render_scals)
