"""Multi-substep step functions (port of ``mpm_tpu.ops.step``).

The reference runs `sim_iterations` substeps per rendered frame
(MLSMPM3DFluidMultithreadGPU.cs:241-249). PyTorch runs eagerly, so a frame
is a Python loop over substeps; there is nothing to compile.

Modes: "bucketed" (plain PyTorch, ops/bucketed.py) and "cuda" (kernels P
and F for a 3D config, sim2d and migrate2d for a 2D one, the per-pass
kernels A, B, D and E under MPM_PALLAS_OLD=1; ops/cuda/) step a
BucketState; "reference" (the dense-scatter oracle, ops/reference.py) and
"binned" (the sorted engine, ops/binned.py) step a linear SimState. "auto"
is "cuda": its kernel wrappers launch the kernels for a state on a CUDA
device and take their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Callable, Sequence

from ..core.params import FluidParams, SimConfig
from ..core.state import SimState
from ..utils.timing import span
from .bucketed import BucketState
from .interact import Interaction

SubstepFn = Callable[..., BucketState | SimState]
FrameFn = Callable[..., BucketState | SimState]


def resolve_substep(mode: str) -> SubstepFn:
    """The substep function for a mode name."""
    if mode == "reference":
        from . import reference

        return reference.substep
    if mode == "binned":
        from . import binned

        return binned.substep
    if mode == "bucketed":
        from . import bucketed

        return bucketed.substep
    if mode in ("auto", "cuda"):
        from .cuda import step as cuda_step

        return cuda_step.resolve()
    raise ValueError(f"unknown step mode: {mode}")


def make_frame_fn(config: SimConfig, mode: str = "auto",
                  substeps: int | None = None) -> FrameFn:
    """The per-frame function: `substeps` substeps (default
    config.substeps) of the mode's substep."""
    substep_fn = resolve_substep(mode)
    n = substeps if substeps is not None else config.substeps

    def frame(state, fp: FluidParams, interactions: Sequence[Interaction] = ()):
        with span("mpm.step.frame"):
            for _ in range(n):
                state = substep_fn(state, config, fp, interactions)
        return state

    return frame


def make_step(config: SimConfig, mode: str = "auto",
              substeps: int | None = None) -> FrameFn:
    """The per-frame step: on a BucketState (ops/bucketed.from_simstate) in
    modes "bucketed", "cuda" and "auto", on a SimState in "reference" and
    "binned"."""
    return make_frame_fn(config, mode, substeps)
