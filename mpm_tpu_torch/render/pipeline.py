"""Render pipeline (port of ``mpm_tpu.render.pipeline``):

    splat points (kernel F's emission, kernel X, or every slot)
    -> z-buffer + sphere dilation (render/splat.py; the splat kernels)
    -> bilateral blur (kernel BL) -> SSFR shade and composite (kernel SH)
    -> u8 tonemap on the device

Modes (screen_space_fluid_rendering.gd:5-7): "default" (full SSFR, with
the thickness pass when SSFRParams.thickness_pass), "velocity_spheres"
(depth-tested spheres coloured by |vel|), "lit_spheres" (lit impostor
spheres), "depth_debug" (the blurred depth in grey, also
SSFRParams.debug_draw_depth), "none" (the background) and "legacy_quad"
(the reference's dormant packed-depth screen-quad chain, render/legacy.py;
bucket states only). Bucket states render through render_frame_buckets or
make_full_frame_step; a particle array (the `--sphere-render-ratio` path,
and the linear states of modes reference and binned) through render_frame.

Under a profiler (utils/timing.span) make_full_frame_step's frame opens
`mpm.frame` and `mpm.frame.substeps`, and each pass its `mpm.render.*`
span: splat (with dilate inside), thickness, blur, shade, u8. On a card
its thickness pass is one replay of a CUDA graph (_ThicknessReplay).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cuda import step as cuda_step
from ..ops.cuda.extract_cells import render_scals_for
from ..ops.fmath import pow_rn
from ..utils.timing import span, spanned
from . import splat, ssfr
from .background import BackgroundScene, render_background
from .camera import Camera, as_view, crop_for_aabb, look_at
from .extract_kernel import extract_cell_splats
from .splat import (buffers_from_zbuffer, extract_band_slot_splats, extract_slot_splats,
                    splat_cells, splat_particles, thickness_deposit)
from .shade_kernel import shade_kernel
from .splat_kernel import MAX_RADIUS_PX
from .ssfr import (SSFRParams, blur_depth, depth_debug_image, lit_spheres_shade, thickness_map,
                   velocity_spheres_composite)

RENDER_DEFAULT = "default"
RENDER_VELOCITY_SPHERES = "velocity_spheres"
RENDER_LIT_SPHERES = "lit_spheres"
RENDER_DEPTH_DEBUG = "depth_debug"
RENDER_NONE = "none"
RENDER_LEGACY_QUAD = "legacy_quad"
RENDER_MODES = (RENDER_DEFAULT, RENDER_VELOCITY_SPHERES, RENDER_LIT_SPHERES,
                RENDER_DEPTH_DEBUG, RENDER_NONE, RENDER_LEGACY_QUAD)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    quality: "cell" z-buffers each cell's nearest particle (kernel X or
    kernel F's emission); "particle" z-buffers every live slot, or with
    `surface_bands` = (top, bottom, side) only the slots of the grid's
    shell. crop: the static fluid crop (y0, x0, ch, cw) of
    camera.crop_for_aabb, or None for the full frame; the dilation, blur
    and shade of the default chain then run on the crop only (the other
    modes ignore it). sphere_render_ratio: the share of a particle array
    render_frame draws."""

    camera: Camera = Camera()
    ssfr: SSFRParams = SSFRParams()
    mode: str = RENDER_DEFAULT
    max_radius_px: int = 6
    sphere_render_ratio: float = 1.0
    background: BackgroundScene = BackgroundScene()
    quality: str = "cell"
    crop: tuple[int, int, int, int] | None = None
    surface_bands: tuple[int, int, int] | None = None


def check_mode(rc: RenderConfig) -> None:
    if rc.mode not in RENDER_MODES:
        raise ValueError(f"unknown render mode {rc.mode!r}")
    if rc.quality not in ("cell", "particle"):
        raise ValueError(f"unknown render quality {rc.quality!r}")
    if not 0 <= rc.max_radius_px <= MAX_RADIUS_PX:
        raise ValueError(f"max_radius_px {rc.max_radius_px} is outside 0..{MAX_RADIUS_PX} (the "
                         "splat kernel stages a tile and its R-pixel halo in shared memory)")


def background_for_view(rc: RenderConfig, view, device=None):
    """The static-camera background (color [H, W, 3], depth [H, W]),
    computed once for a frame loop, on `device` (default: the device of a
    tensor `view`, else the card)."""
    return render_background(rc.camera, view, rc.background, device=device)


def _needs_velocity(rc: RenderConfig) -> bool:
    """The default and depth chains read the depth only: the velocity key
    and its tracking through the dilation run for the sphere modes alone."""
    return rc.mode in (RENDER_VELOCITY_SPHERES, RENDER_LIT_SPHERES)


def _thickness_on(rc: RenderConfig) -> bool:
    return rc.ssfr.thickness_pass and rc.mode == RENDER_DEFAULT


def _active_crop(rc: RenderConfig):
    """The fluid crop applies to the default chain only; the debug, velocity
    and lit modes composite full-frame buffers."""
    if rc.mode != RENDER_DEFAULT or rc.ssfr.debug_draw_depth:
        return None
    return rc.crop


def _frame_from_bufs(bufs, view, rc: RenderConfig, bg_color, bg_depth, cubemap_faces=None,
                     thickness_deposits=None, crop=None, thickness=None) -> torch.Tensor:
    """The mode chain from the splat buffers on. `thickness_deposits`: the
    raw additive buffer of splat.thickness_deposit under the thickness pass,
    None for the constant thickness; or `thickness`, the pass's finished
    map. `crop`: the crop the buffers were made on; blur and shade run on
    it and the shaded crop is composited over the full background."""
    cam = rc.camera
    dev = bufs.depth.device
    if rc.mode == RENDER_LIT_SPHERES:
        return lit_spheres_shade(bufs, bg_color, bg_depth, as_view(view, dev)[:3, :3], rc.ssfr,
                                 cam)
    if rc.mode == RENDER_VELOCITY_SPHERES:
        # |vel| / 10 as red, the depth-map shader's albedo (depth_map.gdshader:87)
        red = bufs.velocity / torch.tensor(10.0, device=dev)
        zero = torch.zeros_like(red)
        return velocity_spheres_composite(bg_color, bg_depth, bufs.depth,
                                          torch.stack([red, zero, zero], dim=-1))
    depth = blur_depth(bufs.depth, rc.ssfr, cam)
    if rc.mode == RENDER_DEPTH_DEBUG or rc.ssfr.debug_draw_depth:
        return depth_debug_image(depth, rc.ssfr)
    tmap = thickness_map(thickness_deposits, rc.ssfr) if thickness_deposits is not None \
        else thickness
    with span("mpm.render.shade"):
        color, _live = shade_kernel(depth, bg_color, bg_depth, cubemap_faces, view, rc.ssfr, cam,
                                    thickness=tmap, crop=crop)
    return color


def render_frame(pos: torch.Tensor, vel_mag: torch.Tensor, view, rc: RenderConfig,
                 cubemap_faces=None, bg=None) -> torch.Tensor:
    """A particle array's frame [H, W, 3]: pos [3, N] and |vel| [N] on the
    frame's device, every particle (or rc.sphere_render_ratio of them)
    z-buffered by sorting, full frame. `bg`: background_for_view's pair,
    else the background is traced here."""
    check_mode(rc)
    cam = rc.camera
    bg_color, bg_depth = bg if bg is not None else background_for_view(rc, view, pos.device)
    if rc.mode == RENDER_NONE:
        return bg_color
    bufs = splat_particles(pos, vel_mag, view, cam,
                           sphere_radius=rc.ssfr.particle_sphere_radius,
                           max_radius_px=rc.max_radius_px,
                           sphere_render_ratio=rc.sphere_render_ratio,
                           with_normals=rc.mode == RENDER_LIT_SPHERES)
    return _frame_from_bufs(bufs, view, rc, bg_color, bg_depth, cubemap_faces=cubemap_faces)


def make_renderer(rc: RenderConfig, cubemap_faces=None):
    """(pos, vel_mag, view) -> frame: render_frame with `rc` bound."""
    def renderer(pos, vel_mag, view):
        return render_frame(pos, vel_mag, view, rc, cubemap_faces=cubemap_faces)

    return renderer


def render_frame_cells(cells: torch.Tensor, view, rc: RenderConfig, bg=None,
                       cubemap_faces=None, thickness_cells=None,
                       thickness_pass=None) -> torch.Tensor:
    """The SSFR chain from splat points [5, M] on: the float frame
    [H, W, 3] on the splats' device. `bg`: the precomputed (color, depth)
    of background_for_view, else the background is traced here.
    `thickness_cells`: the cell splats of the thickness deposit, when they
    are not `cells` (quality "particle"). `thickness_pass`: a callable
    (cell splats -> thickness map) in place of the deposit and the map
    (make_full_frame_step's _ThicknessReplay)."""
    check_mode(rc)
    bg_color, bg_depth = bg if bg is not None else background_for_view(rc, view, cells.device)
    if rc.mode == RENDER_NONE:
        return bg_color
    crop = _active_crop(rc)
    bufs = splat_cells(cells, rc.camera, sphere_radius=rc.ssfr.particle_sphere_radius,
                       max_radius_px=rc.max_radius_px, crop=crop,
                       with_velocity=_needs_velocity(rc),
                       with_normals=rc.mode == RENDER_LIT_SPHERES)
    tdep = tmap = None
    if _thickness_on(rc):
        tcells = cells if thickness_cells is None else thickness_cells
        if thickness_pass is not None:
            tmap = thickness_pass(tcells)
        else:
            tdep = thickness_deposit(tcells, rc.camera,
                                     sphere_radius=rc.ssfr.particle_sphere_radius, crop=crop)
    return _frame_from_bufs(bufs, view, rc, bg_color, bg_depth, cubemap_faces=cubemap_faces,
                            thickness_deposits=tdep, crop=crop, thickness=tmap)


def render_frame_from_zbuffer(d: torch.Tensor, key, view, rc: RenderConfig, bg=None,
                              cubemap_faces=None, thickness_deposits=None) -> torch.Tensor:
    """The chain from a raw (possibly slab-composited) z-buffer on: `key`
    the velocity key for the sphere modes (else None), `thickness_deposits`
    the raw thickness buffer under the thickness pass (else None). Under
    an active crop every buffer must be crop-sized."""
    check_mode(rc)
    bg_color, bg_depth = bg if bg is not None else background_for_view(rc, view, d.device)
    if rc.mode == RENDER_NONE:
        return bg_color
    bufs = buffers_from_zbuffer(d, rc.camera, rc.ssfr.particle_sphere_radius,
                                rc.max_radius_px, key=key,
                                with_normals=rc.mode == RENDER_LIT_SPHERES)
    return _frame_from_bufs(bufs, view, rc, bg_color, bg_depth, cubemap_faces=cubemap_faces,
                            thickness_deposits=thickness_deposits, crop=_active_crop(rc))


def _slot_splats(state, view, rc: RenderConfig, grid_res):
    if rc.surface_bands is None:
        return extract_slot_splats(state, view, rc.camera)
    if grid_res is None:
        raise ValueError("rc.surface_bands needs grid_res (the band slices factor "
                         "the cell axis as [nx, ny, nz]; pass config.grid_res)")
    return extract_band_slot_splats(state, view, rc.camera, grid_res, rc.surface_bands)


def render_frame_buckets(state, view, rc: RenderConfig, bg=None,
                         grid_res: tuple[int, ...] | None = None,
                         cubemap_faces=None, num_particles: int | None = None) -> torch.Tensor:
    """A bucket state's frame [H, W, 3]: kernel X reduces each cell to its
    nearest particle (quality "cell"), or every live slot feeds the
    z-buffer (quality "particle"; with rc.surface_bands only the shell's
    slots, which needs grid_res; the thickness pass then deposits kernel
    X's cell splats). Mode legacy_quad draws render/legacy.legacy_quad_frame,
    whose texture is sized by `num_particles`."""
    check_mode(rc)
    if bg is None:
        bg = background_for_view(rc, view, state.pos.device)
    if rc.mode == RENDER_NONE:
        return bg[0]
    if rc.mode == RENDER_LEGACY_QUAD:
        from .legacy import legacy_quad_frame

        if num_particles is None:
            raise ValueError("legacy_quad mode needs num_particles (the texture contract is "
                             "sized floor(sqrt(n)) + 1, MLSMPM3DFluidMultithreadGPU.cs:196-197)")
        return legacy_quad_frame(state, num_particles, as_view(view, state.pos.device),
                                 rc.camera, bg[0],
                                 sphere_radius=rc.ssfr.particle_sphere_radius,
                                 max_radius_px=rc.max_radius_px)
    tcells = None
    if rc.quality == "particle":
        cells = _slot_splats(state, view, rc, grid_res)
        if _thickness_on(rc):
            tcells = extract_cell_splats(state, view, rc.camera)
    else:
        cells = extract_cell_splats(state, view, rc.camera)
    return render_frame_cells(cells, view, rc, bg=bg, cubemap_faces=cubemap_faces,
                              thickness_cells=tcells)


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


class _ThicknessReplay:
    """The thickness pass (splat.thickness_deposit, then ssfr.thickness_map)
    of one frame step on a card, captured once as a CUDA graph and replayed
    each frame. Its ~110 small eager ops (the deposit's sorted accumulate,
    the Gaussian's taps) then cost the host a copy and a replay, where
    issuing them one by one took the host longer than the card took for
    the whole 1080p frame. The replay runs the captured kernels in their
    order, so its map is bit for bit the eager pass's. The cell splats are
    copied into the graph's own input, and the map returned is the graph's
    own output, overwritten by the next replay: the frame's shade reads it
    before that, in stream order. A replay counts as one call of each
    function, inside one `mpm.render.thickness` span. A new shape of cell
    splats captures anew."""

    def __init__(self, rc: RenderConfig, crop):
        self.rc, self.crop = rc, crop
        self.graph = self.cells = self.tmap = None

    def _pass(self, cells):
        rc = self.rc
        dep = thickness_deposit(cells, rc.camera, sphere_radius=rc.ssfr.particle_sphere_radius,
                                crop=self.crop)
        return thickness_map(dep, rc.ssfr)

    def _capture(self, cells):
        calls = splat.thickness_deposits, ssfr.thickness_maps
        self.graph = None
        self.cells = cells.clone()
        here = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):  # first use (the sort's workspace) outside the capture
            self._pass(self.cells)
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.tmap = self._pass(self.cells)
        self.graph = graph
        splat.thickness_deposits, ssfr.thickness_maps = calls

    def __call__(self, cells: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(cells.device):
            if self.graph is None or cells.shape != self.cells.shape \
                    or cells.dtype != self.cells.dtype:
                self._capture(cells)
            with span("mpm.render.thickness"):
                self.cells.copy_(cells)
                self.graph.replay()
        splat.thickness_deposits += 1
        ssfr.thickness_maps += 1
        return self.tmap


def make_full_frame_step(config, rc: RenderConfig, substeps: int, cubemap_faces=None):
    """The frame step of the render loop: (state, fluid, interactions, view,
    bg) -> (state, u8 frame [H, W, 3] on the state's device). The substeps
    end with kernel F's splat emission; quality "cell" renders those splats,
    quality "particle" the post-step state's slots, and F's cell splats
    then feed the thickness pass only. `bg` is background_for_view's pair,
    or None to trace the background per frame. On a card the thickness
    pass replays its CUDA graph (_ThicknessReplay)."""
    check_mode(rc)
    step = emitting_frame_fn(config, rc.camera, substeps)
    replay = _ThicknessReplay(rc, _active_crop(rc)) if _thickness_on(rc) else None

    @spanned("mpm.frame")
    def fn(state, fp, inter, view, bg):
        with span("mpm.frame.substeps"):
            state, cells = step(state, fp, inter, view)
        tpass = replay if replay is not None and cells.device.type == "cuda" else None
        if rc.quality == "particle":
            img = render_frame_cells(_slot_splats(state, view, rc, config.grid_res), view, rc,
                                     bg=bg, cubemap_faces=cubemap_faces, thickness_cells=cells,
                                     thickness_pass=tpass)
        else:
            img = render_frame_cells(cells, view, rc, bg=bg, cubemap_faces=cubemap_faces,
                                     thickness_pass=tpass)
        return state, frame_to_u8(img)

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


@spanned("mpm.render.u8")
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
