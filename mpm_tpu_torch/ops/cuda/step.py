"""mode="cuda" substep: kernel P then kernel F (the port of
mpm_tpu/ops/pallas/step.py -> fused.substep_fused). For a state on the CPU
both wrappers take their plain PyTorch versions."""

from __future__ import annotations

from typing import Sequence

from ...core.params import FluidParams, SimConfig
from ..bucketed import BucketState
from ..interact import Interaction
from .g2p_migrate import g2p_migrate
from .p2g_update import p2g_update


def substep(state: BucketState, config: SimConfig, fp: FluidParams,
            interactions: Sequence[Interaction] = ()) -> BucketState:
    grid = p2g_update(state, config, fp)
    return g2p_migrate(state, grid, config, fp, interactions)
