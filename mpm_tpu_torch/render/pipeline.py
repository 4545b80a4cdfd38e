"""Render pipeline (port of ``mpm_tpu.render.pipeline``, the bucket-state
path):

    splat points (kernel F's emission, kernel X, or every slot)
    -> z-buffer + sphere dilation (render/splat.py)
    -> bilateral blur (kernel BL) -> SSFR shade -> composite
    -> u8 tonemap on the device

Modes "default" (full SSFR) and "none" (background only). The velocity,
lit-sphere, depth-debug and legacy modes and the thickness pass raise
NotImplementedError until they are ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cuda import step as cuda_step
from ..ops.cuda.extract_cells import render_scals_for
from ..ops.fmath import pow_rn
from .background import BackgroundScene, make_cubemap_sampler, render_background
from .camera import Camera, as_view, crop_for_aabb, look_at
from .extract_kernel import extract_cell_splats
from .splat import extract_band_slot_splats, extract_slot_splats, splat_cells
from .ssfr import SSFRParams, blur_depth, shade

RENDER_DEFAULT = "default"
RENDER_VELOCITY_SPHERES = "velocity_spheres"
RENDER_LIT_SPHERES = "lit_spheres"
RENDER_DEPTH_DEBUG = "depth_debug"
RENDER_NONE = "none"
RENDER_LEGACY_QUAD = "legacy_quad"
RENDER_MODES = (RENDER_DEFAULT, RENDER_NONE)  # the modes this port renders


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    quality: "cell" z-buffers each cell's nearest particle (kernel X or
    kernel F's emission); "particle" z-buffers every live slot, or with
    `surface_bands` = (top, bottom, side) only the slots of the grid's
    shell. crop: the static fluid crop (y0, x0, ch, cw) of
    camera.crop_for_aabb, or None for the full frame; the dilation, blur
    and shade then run on the crop only."""

    camera: Camera = Camera()
    ssfr: SSFRParams = SSFRParams()
    mode: str = RENDER_DEFAULT
    max_radius_px: int = 6
    background: BackgroundScene = BackgroundScene()
    quality: str = "cell"
    crop: tuple[int, int, int, int] | None = None
    surface_bands: tuple[int, int, int] | None = None


def check_mode(rc: RenderConfig) -> None:
    if rc.mode not in RENDER_MODES:
        raise NotImplementedError(
            f"render mode {rc.mode!r} is still to port (ROADMAP.md, queue 1, "
            "item 'render: the velocity, lit, depth-debug and legacy modes')")
    if rc.quality not in ("cell", "particle"):
        raise ValueError(f"unknown render quality {rc.quality!r}")


def background_for_view(rc: RenderConfig, view, device=None):
    """The static-camera background (color [H, W, 3], depth [H, W]),
    computed once for a frame loop, on `device` (default: the device of a
    tensor `view`, else the card)."""
    return render_background(rc.camera, view, rc.background, device=device)


def _active_crop(rc: RenderConfig):
    return rc.crop if rc.mode == RENDER_DEFAULT else None


def _frame_from_bufs(bufs, view, rc: RenderConfig, bg_color, bg_depth,
                     crop=None) -> torch.Tensor:
    """The DEFAULT chain from the splat buffers on: blur, shade, and under
    `crop` the composite of the shaded crop over the full background."""
    cam = rc.camera
    depth = blur_depth(bufs.depth, rc.ssfr, cam)
    color, _live = shade(depth, bg_color, bg_depth, make_cubemap_sampler(None),
                         as_view(view, depth.device)[:3, :3], rc.ssfr, cam, crop=crop)
    if crop is not None:
        y0, x0, ch, cw = crop
        full = bg_color.clone()
        full[y0:y0 + ch, x0:x0 + cw] = color
        color = full
    return color


def render_frame_cells(cells: torch.Tensor, view, rc: RenderConfig, bg=None) -> torch.Tensor:
    """The SSFR chain from splat points [5, M] on: the float frame
    [H, W, 3] on the splats' device. `bg`: the precomputed (color, depth)
    of background_for_view, else the background is traced here."""
    check_mode(rc)
    bg_color, bg_depth = bg if bg is not None else background_for_view(rc, view, cells.device)
    if rc.mode == RENDER_NONE:
        return bg_color
    crop = _active_crop(rc)
    bufs = splat_cells(cells, rc.camera, sphere_radius=rc.ssfr.particle_sphere_radius,
                       max_radius_px=rc.max_radius_px, crop=crop)
    return _frame_from_bufs(bufs, view, rc, bg_color, bg_depth, crop=crop)


def _slot_splats(state, view, rc: RenderConfig, grid_res):
    if rc.surface_bands is None:
        return extract_slot_splats(state, view, rc.camera)
    if grid_res is None:
        raise ValueError("rc.surface_bands needs grid_res (the band slices factor "
                         "the cell axis as [nx, ny, nz]; pass config.grid_res)")
    return extract_band_slot_splats(state, view, rc.camera, grid_res, rc.surface_bands)


def render_frame_buckets(state, view, rc: RenderConfig, bg=None,
                         grid_res: tuple[int, ...] | None = None) -> torch.Tensor:
    """A bucket state's frame [H, W, 3]: kernel X reduces each cell to its
    nearest particle (quality "cell"), or every live slot feeds the
    z-buffer (quality "particle"; with rc.surface_bands only the shell's
    slots, which needs grid_res)."""
    check_mode(rc)
    if bg is None:
        bg = background_for_view(rc, view, state.pos.device)
    if rc.mode == RENDER_NONE:
        return bg[0]
    if rc.quality == "particle":
        cells = _slot_splats(state, view, rc, grid_res)
    else:
        cells = extract_cell_splats(state, view, rc.camera)
    return render_frame_cells(cells, view, rc, bg=bg)


def emitting_frame_fn(config, cam: Camera, substeps: int):
    """(state, fluid, interactions, view) -> (state, cells): substeps - 1
    substeps, then one whose kernel F emits the per-cell splats of the new
    state (ops/cuda/step.substep_emit). On the CPU both run their plain
    versions."""
    def fn(state, fp, inter, view):
        for _ in range(substeps - 1):
            state = cuda_step.substep(state, config, fp, inter)
        return cuda_step.substep_emit(state, config, fp, inter, render_scals_for(view, cam))

    return fn


def make_full_frame_step(config, rc: RenderConfig, substeps: int):
    """The frame step of the render loop: (state, fluid, interactions, view,
    bg) -> (state, u8 frame [H, W, 3] on the state's device). The substeps
    end with kernel F's splat emission; quality "cell" renders those splats,
    quality "particle" the post-step state's slots (as the JAX package does
    since its surface-band fix: the cell splats then feed only the
    thickness pass, which waits). `bg` is background_for_view's pair, or
    None to trace the background per frame."""
    check_mode(rc)
    step = emitting_frame_fn(config, rc.camera, substeps)

    def fn(state, fp, inter, view, bg):
        state, cells = step(state, fp, inter, view)
        if rc.quality == "particle":
            cells = _slot_splats(state, view, rc, config.grid_res)
        return state, frame_to_u8(render_frame_cells(cells, view, rc, bg=bg))

    return fn


def domain_crop(rc: RenderConfig, config, view) -> RenderConfig:
    """rc with the static fluid crop of `config`'s simulation domain under a
    static `view` (camera.crop_for_aabb; positions are clamped to the
    domain, so its box plus the dilation margin bounds every fluid pixel).
    rc unchanged when cropping buys nothing or the mode is not DEFAULT."""
    if rc.mode != RENDER_DEFAULT:
        return rc
    crop = crop_for_aabb(rc.camera, np.asarray(as_view(view)), (0.0,) * len(config.dres),
                         config.dres, margin=rc.max_radius_px + 8)
    return rc if crop is None else dataclasses.replace(rc, crop=crop)


def frame_to_u8(img: torch.Tensor) -> torch.Tensor:
    """Tonemap on the device (gamma 2.2, as image.to_uint8), so frames
    leave the card as u8."""
    g = pow_rn(torch.clamp(img, 0.0, 1.0), float(np.float32(1.0 / 2.2)))
    return (g * 255.0 + 0.5).to(torch.uint8)


def default_view(config_grid_res=(64, 64, 64)) -> torch.Tensor:
    """The default camera, looking at the domain centre from an elevated
    diagonal: a [4, 4] float32 CPU tensor. 3D grids only."""
    if len(config_grid_res) != 3:
        raise ValueError(f"default_view needs a 3D grid, got {config_grid_res}")
    c = [r / 2.0 for r in config_grid_res]
    eye = (c[0] + 55.0, c[1] + 28.0, c[2] + 55.0)
    return torch.from_numpy(look_at(eye, (c[0], c[1] - 8.0, c[2])))
