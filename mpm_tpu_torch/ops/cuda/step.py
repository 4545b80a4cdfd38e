"""mode="cuda" substep: kernel P then kernel F (the port of
mpm_tpu/ops/pallas/step.py -> fused.substep_fused), and the substep whose
kernel F also emits the render's splats (fused.substep_fused_emit). For a
state on the CPU both wrappers take their plain PyTorch versions."""

from __future__ import annotations

from typing import Sequence

import torch

from ...core.params import FluidParams, SimConfig
from ..bucketed import BucketState
from ..interact import Interaction
from .g2p_migrate import g2p_migrate
from .p2g_update import p2g_update


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions)


def substep_emit(state: BucketState, config: SimConfig, fp: FluidParams,
                 interactions: Sequence[Interaction], render_scals: torch.Tensor):
    """substep + kernel F's splat emission: (state, splats [5, C]), splats
    equal to ops/cuda/extract_cells.cell_splats_plain of the new state."""
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions, emit_splats=True,
                       render_scals=render_scals)
