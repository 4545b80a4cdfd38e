"""mode="cuda" substep: kernel P then kernel F for a 3D config, the sim2d
and migrate2d kernels for a 2D one (the port of mpm_tpu/ops/pallas/step.py
-> fused.substep_fused), and the substep whose kernel F also emits the
render's splats (fused.substep_fused_emit). With MPM_PALLAS_OLD=1, as in
the JAX package, `resolve` gives the per-pass substep (ops/cuda/planes.py:
kernels A, B, D and E) instead. For a state on the CPU every wrapper takes
its plain PyTorch version."""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ..bucketed import BucketState
from ..interact import Interaction
from .g2p_migrate import g2p_migrate
from .p2g_update import p2g_update
from .planes import substep as substep_planes
from .substep2d import substep2d


def resolve() -> Callable[..., BucketState]:
    """The mode="cuda" substep: the per-pass substep under MPM_PALLAS_OLD=1
    (read now, not at import), else `substep`. The per-pass substep takes
    3D float32 configs only and raises for any other; it never runs the
    plain engine in their place."""
    if os.environ.get("MPM_PALLAS_OLD", "0") == "1":
        return substep_planes
    return substep


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    if config.dim == 2:
        return substep2d(state, config, fp, interactions)
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions)


def substep_emit(state: BucketState, config: SimConfig, fp: FluidParams,
                 interactions: Sequence[Interaction], render_scals: torch.Tensor):
    """substep + kernel F's splat emission: (state, splats [5, C]), splats
    equal to ops/cuda/extract_cells.cell_splats_plain of the new state.
    3D only, as fused.substep_fused_emit."""
    if config.dim != 3:
        raise ValueError("substep_emit: the splat emission is 3D; 2D scenes draw "
                         "with render/render2d.py")
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions, emit_splats=True,
                       render_scals=render_scals)
