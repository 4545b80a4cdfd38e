"""Procedural background scene and sky (port of
``mpm_tpu.render.background``): a checker floor, a few coloured boxes and
spheres, and a gradient-and-sun sky that doubles as the reflection cubemap.
Cubemap files (`load_cubemap`) are not ported yet."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera, as_view, screen_to_view_dir


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


def sky_color(dirs: torch.Tensor) -> torch.Tensor:
    """Procedural sky: horizon-to-zenith gradient plus a sun disc. dirs
    [..., 3] in world space, y up."""
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)
    horizon = _vec([0.75, 0.85, 0.95], dirs)
    zenith = _vec([0.25, 0.45, 0.75], dirs)
    ground = _vec([0.35, 0.33, 0.3], dirs)
    t = torch.clamp(y, 0.0, 1.0)[..., None]
    sky = horizon * (1.0 - t) + zenith * t
    below = torch.clamp(-y, 0.0, 1.0)[..., None]
    col = sky * (1.0 - below) + ground * below
    sun_dir = np.asarray([0.35, 0.65, 0.2], np.float32)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cos_sun = dot3(dirs, _vec(sun_dir, dirs))
    sun = torch.clamp(_div(cos_sun - 0.998, 0.002), 0.0, 1.0)[..., None]
    return col + sun * _vec([6.0, 5.5, 4.5], dirs)


def make_cubemap_sampler(faces=None):
    """The dirs -> rgb sampler of the reflections: the procedural sky.
    Cubemap faces are not ported yet."""
    if faces is not None:
        raise NotImplementedError(
            "cubemap files are still to port (ROADMAP.md, queue 1, item "
            "'render: cubemap files')")
    return sky_color


def render_background(cam: Camera, view, scene: BackgroundScene = BackgroundScene(),
                      device=None):
    """Ray-trace the background on `device`: (color [H, W, 3], linear
    depth [H, W])."""
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
        t_hit = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
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
