"""Plain SSFR frame of the default render mode at cell quality with the
per-pixel thickness pass, in plain PyTorch, beside reference/render.py
(imported, not changed), which gives every step but the thickness:

    per cell, the nearest valid slot's splat point and the cell's count
    -> the depth chain of reference/render.py (z-buffer, dilation,
       bilateral blur)
    -> the thickness deposit: each splat point on the crop adds
       2r * count * (f / z)^2 at its centre pixel (the cell's material
       column, 2r a particle, times the pixel area of its 1-world-unit
       footprint); off-crop and empty points add nothing
    -> a normalised separable Gaussian (sigma = radius / 2, zero past the
       crop), the X pass then the Y pass
    -> the map max(scale * t, thickness): the material column in world
       units, at least the reference's minimum thickness
    -> the shade of reference/render.py with the map in place of its
       constant: the refraction offset refr.xy * t * refraction_strength
       and Beer's law exp(-density * (1 - diffuse) * t) per pixel
    -> composite on the full frame -> gamma 2.2 -> u8

Departures from a literal reading, each of rounding alone: a pixel's
deposits are summed by index_add_ (on a card in no fixed order); the
Gaussian's weights are normalised in float64, rounded to float32 and
applied tap by tap, the X pass first (the program blurs the Y axis
first). Every value is computed in the dtype of the input arrays
(float32; the control passes bfloat16), TF32 off throughout (`frame`).
Imports nothing of the program."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import render as rref

THICKNESS_MIN = rref.THICKNESS  # the reference's constant, the map's floor


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN inside, as it was after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def deposit(cells, crop, cam: rref.Cam, r: float = rref.SPHERE_R):
    """The additive thickness buffer [h, w] of the crop (the frame for
    None) from the splat points [5, M] (pixel x, pixel y, depth, |vel|,
    count)."""
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    ix = torch.floor(cells[0]).to(torch.int64) - x0
    iy = torch.floor(cells[1]).to(torch.int64) - y0
    on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & (cells[2] < rref.CELL_BG)
    f = torch.tensor(cam.focal, dtype=torch.float32, device=cells.device).to(cells.dtype)
    fz = f / cells[2][on]
    weight = (2.0 * r) * cells[4][on] * (fz * fz)
    out = torch.zeros(h * w, dtype=cells.dtype, device=cells.device)
    return out.index_add_(0, (iy * w + ix)[on], weight).reshape(h, w)


def gaussian(img, radius: int):
    """The normalised separable Gaussian of radius `radius`, sigma radius /
    2, zero outside the image: the X pass, then the Y pass."""
    if radius <= 0:
        return img
    sigma = radius / 2.0
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape
    for axis in (1, 0):
        p = F.pad(img, (radius, radius, 0, 0) if axis == 1 else (0, 0, radius, radius))
        acc = torch.zeros_like(img)
        for i, kv in enumerate(k):
            acc = acc + float(kv) * (p[:, i:i + w] if axis == 1 else p[i:i + h])
        img = acc
    return img


def thickness_map(dep, scale: float, radius: int):
    """max(scale * blurred deposit, the reference's minimum thickness)."""
    return torch.clamp_min(scale * gaussian(dep, radius), THICKNESS_MIN)


def shade(depth, thick, bg_color, bg_depth, view: np.ndarray, cam: rref.Cam, crop):
    """reference/render.shade with the per-pixel thickness `thick` [h, w]
    in place of its constant: colour of the crop over the background."""
    dev = depth.device
    y0, x0 = (crop[0], crop[1]) if crop is not None else (0, 0)
    h, w = depth.shape
    bg_d = bg_depth[y0:y0 + h, x0:x0 + w]
    bg_c = bg_color[y0:y0 + h, x0:x0 + w]
    live = (depth <= rref.FAR_GUARD) & (bg_d >= depth)
    normal = rref._normals(depth, cam, crop)
    ray = rref._ray_dirs(cam, crop, depth)
    rot = rref._t(view, depth)[:3, :3]
    light = rot @ rref._t(rref.LIGHT_DIR, depth)
    light = -light / torch.clamp_min(rref._norm3(light), 1e-9)
    hv = light - ray
    hv = hv / torch.clamp_min(rref._norm3(hv), 1e-9)[..., None]
    spec = torch.pow(torch.clamp_min(rref._dot3(hv, normal), 0.0), rref.SPECULAR_POWER)
    cos_t = rref._dot3(normal, -ray)
    schlick = torch.pow(torch.clamp_min(1.0 - cos_t, 0.0), 5.0)
    fres = torch.clamp(rref.F0 + (1.0 - rref.F0) * schlick, 0.0, rref.FRESNEL_CLAMP)
    refl = rref.sky((ray - 2.0 * cos_t[..., None] * (-normal)) @ rot)
    cos_i = torch.clamp(rref._dot3(-ray, normal), -1.0, 1.0)
    k = 1.0 - rref.ETA * rref.ETA * (1.0 - cos_i * cos_i)
    refr = rref.ETA * ray + (rref.ETA * cos_i - torch.sqrt(torch.clamp_min(k, 0.0)))[..., None] \
        * normal
    uv = refr[..., :2] * (thick[..., None] * rref.REFRACTION)
    fw, fh = cam.width, cam.height
    xs = torch.arange(w, dtype=torch.float32, device=dev).to(depth.dtype) + float(x0)
    ys = torch.arange(h, dtype=torch.float32, device=dev).to(depth.dtype) + float(y0)
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    # clamped again as integers: in bfloat16 the clamp's top fw - 1 rounds up
    sx = torch.clamp(torch.clamp(xg + uv[..., 0] * fw, 0, fw - 1).to(torch.int64), 0, fw - 1)
    sy = torch.clamp(torch.clamp(yg - uv[..., 1] * fh, 0, fh - 1).to(torch.int64), 0, fh - 1)
    transmitted = bg_color.reshape(-1, 3)[sy * fw + sx]
    absorb = -rref.OPTICAL_DENSITY * (1.0 - rref._t(rref.DIFFUSE, depth))
    trans = torch.exp(absorb * thick[..., None])
    color = (transmitted * trans * (1.0 - fres[..., None]) + refl * fres[..., None]
             + spec[..., None])
    return torch.where(live[..., None], color, bg_c)


def frame(pos, vel, mass, view: np.ndarray, cam: rref.Cam, crop, scale: float,
          radius: int) -> torch.Tensor:
    """The u8 frame [H, W, 3] of the bucket arrays (pos, vel, mass) under a
    static `view` with the thickness pass of `scale` and blur `radius`; the
    background is traced here, in pos's dtype."""
    with no_tf32():
        bg = rref.background(cam, view, torch.zeros((), dtype=pos.dtype, device=pos.device))
        cells = rref.cell_splats(pos, vel, mass, view, cam)
        depth = rref.blur(rref.dilate(rref.zbuffer(cells, crop, cam), cam), cam)
        thick = thickness_map(deposit(cells, crop, cam), scale, radius)
        color = shade(depth, thick, bg[0], bg[1], view, cam, crop)
        if crop is not None:
            y0, x0, ch, cw = crop
            full = bg[0].clone()
            full[y0:y0 + ch, x0:x0 + cw] = color
            color = full
        return rref.to_u8(color)
