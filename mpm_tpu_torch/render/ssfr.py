"""Screen-space fluid rendering passes (port of ``mpm_tpu.render.ssfr``):

    bilateral blur X -> bilateral blur Y (kernel BL, render/blur_kernel.py)
    -> shade (normals from depth, Blinn specular, Schlick Fresnel, sky
       reflection, refraction offset, Beer's-law transmittance)
    -> composite over the background

The splat buffers already hold linear view depth. Shading uses the
reference's constant thickness, or with `thickness_pass` the per-pixel
material thickness of splat.thickness_deposit (blurred by `thickness_map`).
The debug views (depth, velocity spheres, lit spheres) composite here too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fmath import pow_rn, sqrt_rn
from ..utils.timing import spanned

from .background import dot3
from .blur_kernel import BG_DEPTH, FAR_GUARD, blur_depth_kernel
from .camera import Camera, as_view, norm3, screen_to_view_dir, view_pos_from_depth

IOR = 1.333
ETA = 1.0 / IOR
F0 = 0.02  # Fresnel at 0 degrees (fluid_render_fixed_depth.glsl:14)
thickness_maps = 0  # calls of thickness_map, on every device (a replay counts as one)

__all__ = ["FAR_GUARD", "IOR", "ETA", "F0", "SSFRParams", "blur_depth", "composite_threshold",
           "depth_debug_image", "gaussian_blur", "lit_spheres_shade", "reconstruct_normals",
           "shade", "thickness_map", "velocity_spheres_composite"]


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
    # the depth debug view (screen_space_fluid_rendering.gd:27-29)
    debug_draw_depth: bool = False
    depth_divisor: float = 100.0
    # The thickness pass the reference skipped: per-pixel material thickness
    # (splat.thickness_deposit, blurred by a normalised Gaussian of radius
    # thickness_blur_radius, times thickness_scale) feeds Beer's law and the
    # refraction offset; `thickness` is then its minimum.
    thickness_pass: bool = False
    thickness_scale: float = 0.05
    thickness_blur_radius: int = 6
    # Refraction-sample stride: 1 = the exact per-pixel dependent gather;
    # N > 1 gathers every Nth pixel and nearest-upsamples.
    refraction_downsample: int = 1


@spanned("mpm.render.blur")
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


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b in IEEE float32 on every device (a CUDA tensor divided by a
    Python number is multiplied by the reciprocal instead)."""
    return a / torch.tensor(float(np.float32(b)), dtype=a.dtype, device=a.device)


def gaussian_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable normalised Gaussian (sigma = radius / 2) of the additive
    thickness deposits; normalised, so it keeps the deposited total. The
    weights are the JAX package's float32 ones, and each pass sums
    acc + k[i] * tap in tap order, the X pass then the Y pass."""
    if radius <= 0:
        return img
    sigma = max(radius / 2.0, 1e-3)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape
    for axis in (0, 1):
        p = F.pad(img, (0, 0, radius, radius) if axis == 0 else (radius, radius, 0, 0))
        acc = torch.zeros_like(img)
        for i, kv in enumerate(k):
            tap = p[i:i + h] if axis == 0 else p[:, i:i + w]
            acc = acc + float(kv) * tap
        img = acc
    return img


@spanned("mpm.render.thickness")
def thickness_map(deposits: torch.Tensor, params: SSFRParams) -> torch.Tensor:
    """Blurred, scaled per-pixel thickness; `params.thickness` is its
    minimum (the reference's `minimum_thickness`)."""
    global thickness_maps
    thickness_maps += 1
    t = gaussian_blur(deposits, params.thickness_blur_radius)
    return torch.clamp_min(params.thickness_scale * t, params.thickness)


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
          thickness: torch.Tensor | None = None, crop=None):
    """The fluid_render_fixed_depth pass (fluid_render_fixed_depth.glsl:52-153).
    `thickness`: the per-pixel map of thickness_map, or None for the
    reference's constant. `bg_color`/`bg_depth` are full-frame; under
    `crop` = (y0, x0, ch, cw) the depth, the thickness and the returned
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
    if thickness is None:
        uv_off = refr_dir[..., :2] * (params.thickness * params.refraction_strength)
    else:
        uv_off = refr_dir[..., :2] * (thickness[..., None] * params.refraction_strength)
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
    t_beer = params.thickness if thickness is None else thickness[..., None]
    transmittance = torch.exp(-params.optical_density * (1.0 - diffuse) * t_beer)
    refr_color = transmitted * transmittance

    color = (refr_color * (1.0 - fresnel[..., None]) + refl_color * fresnel[..., None]
             + spec[..., None])
    return torch.where(live[..., None], color, bg_color_c), live


def depth_debug_image(fluid_depth: torch.Tensor, params: SSFRParams) -> torch.Tensor:
    """Greyscale linear-depth view (particle_depth_visualiser.glsl:58-63)."""
    g = torch.clamp(_div(fluid_depth, params.depth_divisor), 0.0, 1.0)
    g = torch.where(fluid_depth > FAR_GUARD, 1.0, g)
    return torch.stack([g, g, g], dim=-1)


def composite_threshold(dst: torch.Tensor, src: torch.Tensor,
                        color_threshold: float = 0.01) -> torch.Tensor:
    """The copy_texture pass: src where |rgb| >= threshold, else dst
    (copy_texture.glsl:28-33)."""
    return torch.where((norm3(src) >= color_threshold)[..., None], src, dst)


def velocity_spheres_composite(bg_color: torch.Tensor, bg_depth: torch.Tensor,
                               fluid_depth: torch.Tensor,
                               fluid_color: torch.Tensor) -> torch.Tensor:
    """The velocity-spheres mode: the fluid colour, depth-tested over the
    background (fluid_render_velocity_spheres.glsl:50-67)."""
    live = (fluid_depth <= FAR_GUARD) & (bg_depth >= fluid_depth)
    return torch.where(live[..., None], fluid_color, bg_color)


def lit_spheres_shade(bufs, bg_color: torch.Tensor, bg_depth: torch.Tensor,
                      view_rot: torch.Tensor, params: SSFRParams, cam: Camera) -> torch.Tensor:
    """The lit billboard-sphere view (billboard_sphere.gdshader:46-88): the
    impostor normal (sx, -sy, sqrt(1 - s^2)) of SplatBuffers with sx/sy,
    turned (Rodrigues) from +z onto the pixel's direction to the camera,
    diffuse clamp(N.L, 0, 1) / pi * 2.2 plus ambient 0.25 on a uniform
    sphere colour, depth-tested over the background."""
    dev = bufs.depth.device
    sx, sy = bufs.sx, bufs.sy
    s2 = torch.clamp(sx * sx + sy * sy, 0.0, 1.0)
    nx, ny, nz = sx, -sy, sqrt_rn(1.0 - s2)
    view_dir = -screen_to_view_dir(cam, device=dev)  # fragment -> camera
    vx, vy, c = -view_dir[..., 1], view_dir[..., 0], view_dir[..., 2]
    s2v = torch.clamp_min(vx * vx + vy * vy, 1e-12)
    k = (1.0 - c) / s2v
    rx = nx * (1.0 - k * vy * vy) + ny * (k * vx * vy) + nz * vy
    ry = nx * (k * vx * vy) + ny * (1.0 - k * vx * vx) - nz * vx
    rz = -nx * vy + ny * vx + nz * c
    normal = torch.stack([rx, ry, rz], dim=-1)

    rot = as_view(view_rot, dev)[:3, :3]
    light_v = rot @ torch.tensor(params.light_dir, dtype=torch.float32, device=dev)
    to_light = _div(-light_v, float(np.linalg.norm(np.asarray(params.light_dir))))
    ndotl = torch.clamp(dot3(normal, to_light), 0.0, 1.0)
    sphere_color = torch.tensor([0.35, 0.55, 0.95], dtype=torch.float32, device=dev)
    lit = (0.25 + _div(ndotl[..., None], np.pi) * 2.2) * sphere_color
    live = (bufs.depth < BG_DEPTH) & (bufs.depth < bg_depth)
    return torch.where(live[..., None], lit, bg_color)
