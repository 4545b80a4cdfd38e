"""The settled 1M benchmark pool and its two render recipes (the JAX
package's bench.py with-render lines), shared by chip_smoke.py and
utils/profile_render so that both measure the same loop.
"""

from __future__ import annotations

import time

import torch

from ..ops.window import YWindow
from ..render import Camera, RenderConfig, SSFRParams, domain_crop
from ..render.splat import fit_surface_bands

N_POOL = 1_000_000
SETTLE_CHUNKS = 15  # chunks of 10 substeps: 150 substeps to settle


def pool_window(pool) -> YWindow:
    """The air-window engine of the pool: kernel mode, 10-substep chunks,
    headroom 4."""
    return YWindow(pool.config, mode="cuda", substeps=10, headroom=4)


def settle(win: YWindow, state, fluid):
    """150 substeps through the window engine."""
    for _ in range(SETTLE_CHUNKS):
        state = win.step(state, fluid)
    return state


def recipe_360(scene_config, view) -> RenderConfig:
    """640x360, cell quality, cropped to the scene's domain (the scene's
    full config, not the window's)."""
    return domain_crop(RenderConfig(camera=Camera(width=640, height=360)), scene_config, view)


def recipe_1080(scene_config, state, grid_res, view) -> RenderConfig:
    """1920x1080, particle quality, R=8, refraction downsample 4, with
    surface bands fitted on `state` over the window's `grid_res`, cropped
    to the scene's domain."""
    bands = fit_surface_bands(state, grid_res)
    if bands is None:
        raise RuntimeError("no surface band fits the state")
    return domain_crop(RenderConfig(camera=Camera(width=1920, height=1080), quality="particle",
                                    max_radius_px=8, ssfr=SSFRParams(refraction_downsample=4),
                                    surface_bands=bands), scene_config, view)


def frame_windows(frame, state, fluid, view, bg, frames: int, windows: int):
    """`windows` fenced windows of `frames` frames of make_full_frame_step's
    `frame`; each u8 frame is copied to pinned host memory as it is made.
    Returns (state, last u8 frame, seconds per window)."""
    img = host = None
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            state, img = frame(state, fluid, (), view, bg)
            if host is None:
                host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, img, times
