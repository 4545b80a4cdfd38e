"""mpm_tpu_torch — the MLS-MPM engine of ``mpm_tpu`` ported to PyTorch, with
its simulation kernels written by hand in CUDA for NVIDIA Hopper.

The package mirrors ``mpm_tpu``'s module names; ``ops/pallas`` becomes
``ops/cuda`` and the CUDA sources live in ``csrc``. It imports PyTorch and
numpy only.
"""

from .core.params import BC_FRICTION, BC_SLIP, BC_STICK, FluidParams, SimConfig
from .core.state import Grid, SimState, make_state, zero_grid
from .models.scenes import SCENES, Scene, get_scene
from .ops.bucketed import BucketState
from .ops.interact import Interaction
from .ops.step import make_step
from .ops.window import YWindow

__version__ = "0.1.0"

__all__ = [
    "BC_FRICTION",
    "BC_SLIP",
    "BC_STICK",
    "BucketState",
    "FluidParams",
    "Grid",
    "Interaction",
    "SCENES",
    "Scene",
    "SimConfig",
    "SimState",
    "YWindow",
    "get_scene",
    "make_state",
    "make_step",
    "zero_grid",
]
