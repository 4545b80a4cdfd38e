"""The sharded render composite (port of ``mpm_tpu.parallel.render``):
BASELINE config 5's render clause.

Per frame:

  1. every slab runs its substeps (parallel/domain.py), kernel F emitting
     the per-cell splats of the slab's own planes on the last one;
  2. every slab z-buffers its splats on its device (render/splat.
     zbuffer_cells, on the crop), with the velocity key for the sphere
     modes and the thickness deposit under the thickness pass;
  3. an elementwise torch.minimum merges the slabs' depth buffers and keys
     on the first slab's device, the counterpart of the JAX package's
     pmin. The slabs own disjoint cells, and a min over disjoint sets is
     the min over their union, so these composites equal the whole grid's
     buffers bit for bit. The thickness deposits are added in slab order
     (the psum): a sum in another order than the whole grid's, so the
     thickness frame matches the single-device one only to rounding;
  4. the dilation, blur, shade and u8 tonemap run once, on the composite.

A frame moves [H, W] buffers between devices, never the state.
"""

from __future__ import annotations

import torch

from ..core.params import FluidParams, SimConfig
from ..ops.cuda.extract_cells import render_scals_for
from ..render.pipeline import (RENDER_NONE, RenderConfig, _active_crop, _needs_velocity,
                               _thickness_on, background_for_view, check_mode, frame_to_u8,
                               render_frame_from_zbuffer)
from ..render.splat import thickness_deposit, velocity_key, zbuffer_cells
from .domain import ShardedState, SlabMesh, make_sharded_frame_fn


def make_sharded_frame_step(config: SimConfig, mesh: SlabMesh, rc: RenderConfig,
                            substeps: int | None = None, mode: str = "auto",
                            cubemap_faces=None):
    """(state, fluid, interactions, view, bg) -> (state, u8 frame [H, W, 3]
    on the first slab's device) over a ShardedState: the sharded substeps
    with splat emission on the last, the per-slab buffers, their
    composites, and the render chain. Quality "cell" only (the composite
    merges cell splats). `bg` is background_for_view's pair, or None to
    trace it."""
    check_mode(rc)
    if rc.quality != "cell":
        raise ValueError("the sharded render composites cell splats: quality 'cell' only")
    frame_fn = make_sharded_frame_fn(config, mesh, substeps, mode)
    cam = rc.camera
    crop = _active_crop(rc)
    with_vel, with_thick = _needs_velocity(rc), _thickness_on(rc)
    dev0 = mesh.devices[0]

    def merge(parts, op):
        out = None
        for p in parts:
            p = p.to(dev0)
            out = p if out is None else op(out, p)
        return out

    def step(state: ShardedState, fp: FluidParams, interactions, view, bg):
        bg_color, bg_depth = bg if bg is not None else background_for_view(rc, view, dev0)
        if rc.mode == RENDER_NONE:
            return frame_fn(state, fp, interactions)[0], frame_to_u8(bg_color)
        state, splats = frame_fn(state, fp, interactions, render_scals_for(view, cam))
        depth = merge((zbuffer_cells(sp, cam, crop=crop) for sp in splats), torch.minimum)
        key = (merge((velocity_key(sp, cam, crop) for sp in splats), torch.minimum)
               if with_vel else None)
        tdep = (merge((thickness_deposit(sp, cam, rc.ssfr.particle_sphere_radius, crop)
                       for sp in splats), torch.add) if with_thick else None)
        img = render_frame_from_zbuffer(depth, key, view, rc, bg=(bg_color, bg_depth),
                                        cubemap_faces=cubemap_faces, thickness_deposits=tdep)
        return state, frame_to_u8(img)

    return step


def demo_sharded_render(n_slabs: int, device="cuda") -> None:
    """One sharded frame of a tiny pool on n_slabs slabs of one device
    (render.py:190-233), whole-grid and y-windowed: no particle lost, no
    ceiling hit, and the frame equal to make_full_frame_step's from the
    same state."""
    from ..core.state import make_state
    from ..models.emitters import box_lattice
    from ..ops.bucketed import from_simstate
    from ..ops.window import window_config
    from ..render import Camera, make_full_frame_step
    from ..render.camera import look_at
    from .domain import shard_bucket_state

    mesh = SlabMesh.on(device, n_slabs)
    grid = (16, 16, 16)
    pos = box_lattice(grid, (10.0, 6.0, 10.0), 0.8, center=(8.0, 6.0, 8.0))
    config = SimConfig(grid_res=grid, num_particles=pos.shape[0], substeps=1, bin_capacity=8)
    fluid = FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0)
    rc = RenderConfig(camera=Camera(width=128, height=96))
    view = torch.from_numpy(look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0)))
    bg = background_for_view(rc, view, mesh.devices[0])
    state = make_state(pos, device)
    for cfg in (config, window_config(config.replace(grid_res=(16, 32, 16)), 16)):
        b0 = from_simstate(state, cfg)
        out, img = make_sharded_frame_step(cfg, mesh, rc)(
            shard_bucket_state(b0, cfg, mesh), fluid, (), view, bg)
        _, want = make_full_frame_step(cfg, rc, cfg.substeps)(b0, fluid, (), view, bg)
        if int(out.lost) != 0 or int(out.ceiling) != 0 or tuple(img.shape) != (96, 128, 3):
            raise AssertionError(f"demo_sharded_render {cfg.grid_res}: lost {int(out.lost)} "
                                 f"ceiling {int(out.ceiling)} frame {tuple(img.shape)}")
        if not torch.equal(img, want):
            raise AssertionError(f"demo_sharded_render {cfg.grid_res}: the sharded frame "
                                 f"differs from the single-device frame in "
                                 f"{int((img != want).any(dim=-1).sum())} pixels")
