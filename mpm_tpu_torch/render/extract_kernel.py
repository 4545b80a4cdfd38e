"""Kernel X: bucket state -> per-cell nearest splat points, in hand-written
CUDA (csrc/extract_cells.cu) beside its plain PyTorch version (port of
``mpm_tpu.render.extract_kernel``).

Per cell, the minimum-depth valid slot wins (mass > 0, beyond the near
plane; the first in slot order on a tie) and its exact position and velocity
are kept: occlusion within one cell is dropped before the per-pixel
z-buffer, which the bilateral blur hides. Output rows: (pixel x, pixel y,
linear depth, |vel|, valid count); depth CELL_BG marks an empty cell. The
per-cell code and its plain version are shared with kernel F's emission
(csrc/extract_cells.cuh, ops/cuda/extract_cells.py).

`extract_cell_splats(state, view, cam)` takes the plain version for a state
on the CPU and launches kernel X for a state on a CUDA device; there is no
other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.cuda import build
from ..ops.cuda.extract_cells import (CELL_BG, cell_splats_plain, render_scals_for,
                                     scals_arg)

launches = 0  # kernel launches by extract_cell_splats (plain calls not counted)


def extract_cell_splats_plain(state, view, cam) -> torch.Tensor:
    """The plain PyTorch version of kernel X on a BucketState: [5, C]."""
    return cell_splats_plain(state.pos, state.vel, state.mass,
                             render_scals_for(view, cam))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("extract_cells")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.extract_cells.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
    lib.extract_cells.restype = ci
    lib.extract_cells_scals.argtypes = []
    lib.extract_cells_scals.restype = ci
    if lib.extract_cells_scals() != 16:
        raise RuntimeError("RenderScals layout differs between csrc and Python")
    return lib


def _check_bucket_arrays(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor) -> None:
    k, c = mass.shape
    dev = pos.device
    for name, t, shape, dtypes in (
            ("pos", pos, (3, k, c), (torch.float32,)),
            ("vel", vel, (3, k, c), (torch.float32, torch.bfloat16)),
            ("mass", mass, (k, c), (torch.float32,))):
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"{name}: want {shape} {dtypes}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def extract_cell_splats(state, view, cam) -> torch.Tensor:
    """[5, C]: (pixel x, pixel y, linear depth, |vel|, valid count) of each
    cell's nearest valid slot: the plain version on the CPU, kernel X on
    CUDA."""
    global launches
    dev = state.pos.device
    if dev.type == "cpu":
        return extract_cell_splats_plain(state, view, cam)
    if dev.type != "cuda":
        raise ValueError(f"kernel X runs on CUDA devices, not {dev}")
    _check_bucket_arrays(state.pos, state.vel, state.mass)
    k, c = state.mass.shape
    scals = render_scals_for(view, cam)
    out = torch.empty((5, c), dtype=torch.float32, device=dev)
    with build.on_device(dev):
        rc = _lib().extract_cells(state.pos.data_ptr(), state.vel.data_ptr(),
                                  state.mass.data_ptr(), scals_arg(scals), k, c,
                                  int(state.vel.dtype == torch.bfloat16), out.data_ptr(),
                                  build.stream_of(dev))
    build.check_rc("extract_cells", rc)
    launches += 1
    return out
