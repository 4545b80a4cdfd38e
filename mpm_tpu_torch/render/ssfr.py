"""Screen-space fluid rendering passes (port of ``mpm_tpu.render.ssfr``):

    bilateral blur X -> bilateral blur Y (kernel BL, render/blur_kernel.py)
    -> shade (normals from depth, Blinn specular, Schlick Fresnel, sky
       reflection, refraction offset, Beer's-law transmittance)
    -> composite over the background

The splat buffers already hold linear view depth. Shading uses the
reference's constant thickness; the thickness pass waits (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fmath import pow_rn, sqrt_rn

from .background import dot3
from .blur_kernel import FAR_GUARD, blur_depth_kernel
from .camera import Camera, as_view, norm3, screen_to_view_dir, view_pos_from_depth

IOR = 1.333
ETA = 1.0 / IOR
F0 = 0.02  # Fresnel at 0 degrees (fluid_render_fixed_depth.glsl:14)

__all__ = ["FAR_GUARD", "IOR", "ETA", "F0", "SSFRParams", "blur_depth",
           "reconstruct_normals", "shade"]


@dataclasses.dataclass(frozen=True)
class SSFRParams:
    """Tunables of the SSFR effect (screen_space_fluid_rendering.gd:5-30),
    reference defaults. The blur runs radius `max_filter_size` on every
    device."""

    particle_sphere_radius: float = 1.0
    depth_blur_enabled: bool = True
    blur_depth_scale: float = 10.0
    max_filter_size: int = 100
    blur_filter_size: float = 7.0
    diffuse_color: tuple[float, float, float] = (0.085, 0.6375, 0.765)
    thickness: float = 1.0  # the reference's constant "minimum_thickness"
    optical_density: float = 2.0
    refraction_strength: float = 0.1
    specular_power: float = 250.0
    fresnel_clamp: float = 1.0
    light_dir: tuple[float, float, float] = (0.0, -1.0, 0.0)  # world, toward scene
    # Refraction-sample stride: 1 = the exact per-pixel dependent gather;
    # N > 1 gathers every Nth pixel and nearest-upsamples.
    refraction_downsample: int = 1


def blur_depth(depth: torch.Tensor, params: SSFRParams, cam: Camera) -> torch.Tensor:
    """The bilateral depth blur: kernel BL on CUDA, its plain version on
    the CPU."""
    if not params.depth_blur_enabled:
        return depth
    r = params.particle_sphere_radius
    return blur_depth_kernel(depth, cam, radius=params.max_filter_size,
                             max_filter=params.max_filter_size,
                             blur_filter_size=params.blur_filter_size * r,
                             depth_threshold=r * params.blur_depth_scale)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def reconstruct_normals(depth: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """View-space normals from min-magnitude depth differences
    (fluid_render_fixed_depth.glsl:103-119). Under `crop` the wrap at the
    crop's edges touches only pixels the crop margin keeps free of fluid."""
    vpos = view_pos_from_depth(cam, depth, crop=crop)

    def pick(axis):
        d1 = torch.roll(vpos, -1, dims=axis) - vpos
        d2 = -(torch.roll(vpos, 1, dims=axis) - vpos)
        return torch.where((torch.abs(d1[..., 2]) > torch.abs(d2[..., 2]))[..., None],
                           d2, d1)

    n = _cross(pick(0), pick(1))
    return n / torch.clamp_min(norm3(n), 1e-9)[..., None]


def shade(fluid_depth: torch.Tensor, bg_color: torch.Tensor, bg_depth: torch.Tensor,
          cubemap_sample, view_rot: torch.Tensor, params: SSFRParams, cam: Camera,
          crop=None):
    """The fluid_render_fixed_depth pass (fluid_render_fixed_depth.glsl:52-153)
    with the reference's constant thickness. `bg_color`/`bg_depth` are
    full-frame; under `crop` = (y0, x0, ch, cw) the depth and the returned
    colour and mask are crop-sized. Returns (color [H, W, 3], mask [H, W])."""
    dev = fluid_depth.device
    if crop is not None:
        y0c, x0c, chc, cwc = crop
        bg_depth_c = bg_depth[y0c:y0c + chc, x0c:x0c + cwc]
        bg_color_c = bg_color[y0c:y0c + chc, x0c:x0c + cwc]
    else:
        y0c, x0c = 0, 0
        bg_depth_c, bg_color_c = bg_depth, bg_color
    live = (fluid_depth <= FAR_GUARD) & (bg_depth_c >= fluid_depth)

    normal = reconstruct_normals(fluid_depth, cam, crop=crop)
    ray_dir = screen_to_view_dir(cam, crop=crop, device=dev)

    # light direction into view space; it points from the surface toward
    # the light in the half-vector formula
    rot = as_view(view_rot, dev)[:3, :3]
    light_v = rot @ torch.tensor(params.light_dir, dtype=torch.float32, device=dev)
    light_v = -light_v / torch.clamp_min(norm3(light_v), 1e-9)

    hvec = light_v - ray_dir
    hvec = hvec / torch.clamp_min(norm3(hvec), 1e-9)[..., None]
    spec = pow_rn(torch.clamp_min(dot3(hvec, normal), 0.0), params.specular_power)

    cos_t = dot3(normal, -ray_dir)
    fresnel = torch.clamp(F0 + (1.0 - F0) * pow_rn(torch.clamp_min(1.0 - cos_t, 0.0), 5.0),
                          0.0, params.fresnel_clamp)

    # sky reflection: reflect in view space, rotate to world for sampling
    refl_v = ray_dir - 2.0 * cos_t[..., None] * (-normal)
    refl_color = cubemap_sample(refl_v @ rot)

    # refraction: offset the background lookup by the refracted direction
    cos_i = torch.clamp(dot3(-ray_dir, normal), -1.0, 1.0)
    k = 1.0 - ETA * ETA * (1.0 - cos_i * cos_i)
    refr_dir = ETA * ray_dir + (ETA * cos_i - sqrt_rn(torch.clamp_min(k, 0.0)))[
        ..., None] * normal
    h, w = fluid_depth.shape
    uv_off = refr_dir[..., :2] * (params.thickness * params.refraction_strength)
    # pixel coordinates and the offset scale stay in full-frame terms
    fw, fh = cam.width, cam.height
    xs = torch.arange(w, dtype=torch.float32, device=dev) + float(x0c)
    ys = torch.arange(h, dtype=torch.float32, device=dev) + float(y0c)
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    sx = torch.clamp(xg + uv_off[..., 0] * fw, 0, fw - 1).to(torch.int64)
    sy = torch.clamp(yg - uv_off[..., 1] * fh, 0, fh - 1).to(torch.int64)
    bg_rows = bg_color.reshape(-1, 3)
    ds = int(params.refraction_downsample)
    if ds > 1:
        # strided gather, then nearest upsample: pixel (y, x) takes the
        # sample of (y // ds * ds, x // ds * ds)
        tsm = bg_rows[sy[::ds, ::ds] * fw + sx[::ds, ::ds]]
        iy = torch.arange(h, device=dev) // ds
        ix = torch.arange(w, device=dev) // ds
        transmitted = tsm[iy][:, ix]
    else:
        transmitted = bg_rows[sy * fw + sx]

    diffuse = torch.tensor(np.asarray(params.diffuse_color, np.float32), device=dev)
    transmittance = torch.exp(-params.optical_density * (1.0 - diffuse) * params.thickness)
    refr_color = transmitted * transmittance

    color = (refr_color * (1.0 - fresnel[..., None]) + refl_color * fresnel[..., None]
             + spec[..., None])
    return torch.where(live[..., None], color, bg_color_c), live
