"""Procedural background scene and sky (port of
``mpm_tpu.render.background``): a checker floor, a few coloured boxes and
spheres, and a gradient-and-sun sky that doubles as the reflection cubemap,
unless six PNG cubemap faces are given (`load_cubemap`)."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from ..ops.fmath import sqrt_rn

from .camera import Camera, as_view, screen_to_view_dir
from .image import read_png_rgb


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple[float, float, float]
    radius: float
    color: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Box:
    lo: tuple[float, float, float]
    hi: tuple[float, float, float]
    color: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class BackgroundScene:
    """Floor plus coloured primitives (the reference's test scene)."""

    floor_y: float = 2.0  # the sim domain's lower wall
    floor_color_a: tuple[float, float, float] = (0.55, 0.55, 0.6)
    floor_color_b: tuple[float, float, float] = (0.35, 0.35, 0.4)
    checker: float = 8.0
    spheres: tuple[Sphere, ...] = (
        Sphere((85.0, 10.0, 40.0), 8.0, (0.8, 0.2, 0.2)),
        Sphere((-20.0, 8.0, 20.0), 6.0, (0.2, 0.7, 0.2)),
    )
    boxes: tuple[Box, ...] = (
        Box((70.0, 2.0, 70.0), (90.0, 18.0, 90.0), (0.9, 0.7, 0.2)),
        Box((-30.0, 2.0, -20.0), (-14.0, 14.0, -4.0), (0.25, 0.35, 0.9)),
    )


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=like.device)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b in IEEE float32 on every device (a CUDA tensor divided by a
    Python number is multiplied by the reciprocal instead)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (size 3) of a * b, left to right."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


# The procedural sky's constants (kernel SH gets them by value, shade_kernel.py).
SKY_HORIZON = (0.75, 0.85, 0.95)
SKY_ZENITH = (0.25, 0.45, 0.75)
SKY_GROUND = (0.35, 0.33, 0.3)
SUN_DIR = np.asarray([0.35, 0.65, 0.2], np.float32)
SUN_DIR = SUN_DIR / np.linalg.norm(SUN_DIR)  # float32
SUN_COS, SUN_WIDTH = 0.998, 0.002  # the disc ramps up from cos_sun = SUN_COS over SUN_WIDTH
SUN_COLOR = (6.0, 5.5, 4.5)


def sky_color(dirs: torch.Tensor) -> torch.Tensor:
    """Procedural sky: horizon-to-zenith gradient plus a sun disc. dirs
    [..., 3] in world space, y up."""
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)
    horizon = _vec(SKY_HORIZON, dirs)
    zenith = _vec(SKY_ZENITH, dirs)
    ground = _vec(SKY_GROUND, dirs)
    t = torch.clamp(y, 0.0, 1.0)[..., None]
    sky = horizon * (1.0 - t) + zenith * t
    below = torch.clamp(-y, 0.0, 1.0)[..., None]
    col = sky * (1.0 - below) + ground * below
    cos_sun = dot3(dirs, _vec(SUN_DIR, dirs))
    sun = torch.clamp(_div(cos_sun - SUN_COS, SUN_WIDTH), 0.0, 1.0)[..., None]
    return col + sun * _vec(SUN_COLOR, dirs)


def make_cubemap_sampler(faces: torch.Tensor | None = None):
    """The dirs [..., 3] (world) -> rgb sampler of the reflections: the
    procedural sky, or a cubemap faces [6, F, F, 3] in Godot's face order
    (+x, -x, +y, -y, +z, -z), sampled at the nearest texel of the face of
    the dominant axis."""
    if faces is None:
        return sky_color
    f = faces.shape[1]

    def sample(dirs: torch.Tensor) -> torch.Tensor:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        is_x = (ax >= ay) & (ax >= az)
        is_y = ~is_x & (ay >= az)
        face = torch.where(is_x, torch.where(x > 0, 0, 1),
                           torch.where(is_y, torch.where(y > 0, 2, 3),
                                       torch.where(z > 0, 4, 5)))
        ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-9)
        u = torch.where(is_x, torch.where(x > 0, -z, z),
                        torch.where(is_y, x, torch.where(z > 0, x, -x)))
        v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
        ui = torch.clamp(((u / ma + 1.0) * 0.5 * (f - 1)).to(torch.int64), 0, f - 1)
        vi = torch.clamp(((v / ma + 1.0) * 0.5 * (f - 1)).to(torch.int64), 0, f - 1)
        return faces.to(dirs.device)[face, vi, ui]

    return sample


def load_cubemap(source, device="cuda") -> torch.Tensor:
    """Six PNG faces as the [6, F, F, 3] float32 tensor (on `device`) of
    make_cubemap_sampler, in Godot's face order (+x, -x, +y, -y, +z, -z):
    the headless counterpart of the reference's image-array cubemap
    (screen_space_fluid_rendering.gd:71-83). `source` is a sequence of six
    paths in face order, or a directory of `<stem>-1.png .. <stem>-6.png`
    (the reference's naming) or of `{px,nx,py,ny,pz,nz}.png`."""
    if isinstance(source, (list, tuple)):
        paths = list(source)
    else:
        godot = sorted(glob.glob(os.path.join(source, "*-[1-6].png")))
        named = [os.path.join(source, f"{n}.png") for n in ("px", "nx", "py", "ny", "pz", "nz")]
        if len(godot) == 6:
            paths = godot
        elif all(os.path.exists(p) for p in named):
            paths = named
        else:
            raise FileNotFoundError(f"no 6-face cubemap found in {source!r} (expected "
                                    "*-1..6.png or px/nx/py/ny/pz/nz.png)")
    faces = [np.asarray(read_png_rgb(p), np.float32) / 255.0 for p in paths]
    shapes = {f.shape for f in faces}
    if len(shapes) != 1 or faces[0].shape[0] != faces[0].shape[1]:
        raise ValueError(f"cubemap faces must be square and equal: {shapes}")
    return torch.from_numpy(np.stack(faces)).to(device)


def render_background(cam: Camera, view, scene: BackgroundScene = BackgroundScene(),
                      device=None):
    """Ray-trace the background on `device` (default: the device of a
    tensor `view`, else the card): (color [H, W, 3], linear depth [H, W])."""
    if device is None:
        device = view.device if isinstance(view, torch.Tensor) else "cuda"
    v = as_view(view, device)
    rot = v[:3, :3]
    eye = -(rot.T @ v[:3, 3])
    dirs_v = screen_to_view_dir(cam, device=device)
    dirs = dirs_v @ rot  # to world (R^T per pixel)

    t_best = torch.full(dirs.shape[:2], float(np.float32(cam.far)), device=device)
    c_best = sky_color(dirs)

    # floor plane y = floor_y
    denom = dirs[..., 1]
    steep = torch.abs(denom) > 1e-6
    t_floor = (scene.floor_y - eye[1]) / torch.where(steep, denom, 1e-6)
    hit_f = (t_floor > 0) & steep
    p = eye + dirs * t_floor[..., None]
    check = torch.remainder(torch.floor(_div(p[..., 0], scene.checker))
                            + torch.floor(_div(p[..., 2], scene.checker)), 2.0) < 1.0
    fcol = torch.where(check[..., None], _vec(scene.floor_color_a, dirs),
                       _vec(scene.floor_color_b, dirs))
    take = hit_f & (t_floor < t_best)
    t_best = torch.where(take, t_floor, t_best)
    c_best = torch.where(take[..., None], fcol, c_best)

    for s in scene.spheres:
        center = _vec(s.center, dirs)
        oc = eye - center
        b = dot3(dirs, oc)
        c = dot3(oc, oc) - s.radius * s.radius
        disc = b * b - c
        t_hit = -b - sqrt_rn(torch.clamp_min(disc, 0.0))
        hit = (disc > 0) & (t_hit > 0) & (t_hit < t_best)
        pth = eye + dirs * t_hit[..., None]
        n = _div(pth - center, s.radius)
        lam = 0.35 + 0.65 * torch.clamp(n[..., 1], 0.0, 1.0)
        t_best = torch.where(hit, t_hit, t_best)
        c_best = torch.where(hit[..., None], _vec(s.color, dirs) * lam[..., None], c_best)

    for box in scene.boxes:
        lo, hi = _vec(box.lo, dirs), _vec(box.hi, dirs)
        inv = torch.reciprocal(torch.where(torch.abs(dirs) > 1e-6, dirs, 1e-6))
        t0 = (lo - eye) * inv
        t1 = (hi - eye) * inv
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit = (tmax > torch.clamp_min(tmin, 0.0)) & (tmin > 0) & (tmin < t_best)
        t_best = torch.where(hit, tmin, t_best)
        c_best = torch.where(hit[..., None], _vec(box.color, dirs) * 0.85, c_best)

    depth = t_best * (-dirs_v[..., 2])
    return c_best, depth
