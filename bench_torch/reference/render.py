"""Plain SSFR frame of the default render mode at cell quality, from the
bucket arrays after a substep, in plain PyTorch:

    per cell, the nearest valid slot's splat point (pixel, depth, |vel|)
    -> scatter-min z-buffer on the static crop -> sphere dilation (radius R)
    -> separable bilateral depth blur -> normals, Blinn specular, Schlick
       Fresnel, sky reflection, refraction, Beer's law over a ray-traced
       background -> composite on the full frame -> gamma 2.2 -> u8

Every value is computed in the dtype of the input arrays (float32; the
control passes bfloat16). Constants are the reference's defaults
(screen_space_fluid_rendering.gd, MLSMPM3DFluidMultithreadGPU.cs): a
pinhole of 75 degrees, spheres of radius 1 dilated to at most 6 pixels,
blur scale 10, filter 7 up to 100 taps, the procedural sky and the
checker-floor test scene.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

BG_DEPTH = 4000.0
FAR_GUARD = 3990.0
CELL_BG = 1.0e9
ETA = 1.0 / 1.333
F0 = 0.02
SPHERE_R = 1.0
MAX_RADIUS_PX = 6
BLUR_DEPTH_SCALE = 10.0
MAX_FILTER = 100
BLUR_FILTER = 7.0
DIFFUSE = (0.085, 0.6375, 0.765)
THICKNESS = 1.0
OPTICAL_DENSITY = 2.0
REFRACTION = 0.1
SPECULAR_POWER = 250.0
FRESNEL_CLAMP = 1.0
LIGHT_DIR = (0.0, -1.0, 0.0)
FLOOR_Y = 2.0
FLOOR_A, FLOOR_B, CHECKER = (0.55, 0.55, 0.6), (0.35, 0.35, 0.4), 8.0
SPHERES = (((85.0, 10.0, 40.0), 8.0, (0.8, 0.2, 0.2)), ((-20.0, 8.0, 20.0), 6.0, (0.2, 0.7, 0.2)))
BOXES = (((70.0, 2.0, 70.0), (90.0, 18.0, 90.0), (0.9, 0.7, 0.2)),
         ((-30.0, 2.0, -20.0), (-14.0, 14.0, -4.0), (0.25, 0.35, 0.9)))


@dataclasses.dataclass(frozen=True)
class Cam:
    width: int
    height: int
    fov_y_deg: float = 75.0
    near: float = 0.05
    far: float = 4000.0

    @property
    def focal(self) -> float:
        return (self.height / 2.0) / math.tan(math.radians(self.fov_y_deg) / 2.0)


def look_at(eye, target) -> np.ndarray:
    eye, target = np.asarray(eye, np.float32), np.asarray(target, np.float32)
    up = np.asarray((0.0, 1.0, 0.0), np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    rot = np.stack([right, np.cross(right, fwd), -fwd])
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view


def scene_view(grid_res, eye_offset, target_offset) -> np.ndarray:
    """The static camera: from the domain centre plus `eye_offset` toward
    the centre plus `target_offset`."""
    c = [r / 2.0 for r in grid_res]
    return look_at([c[a] + eye_offset[a] for a in range(3)],
                   [c[a] + target_offset[a] for a in range(3)])


def crop_for(cam: Cam, view: np.ndarray, hi, margin: int = MAX_RADIUS_PX + 8, align_x: int = 128,
             align_y: int = 8):
    """The static screen rectangle (y0, x0, ch, cw) that holds the domain
    box [0, hi] plus `margin` pixels under `view`, or None for the frame."""
    lo = np.zeros(3, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)
    v = view[:3, :3] @ corners.T + view[:3, 3][:, None]
    depth = -v[2]
    if float(depth.min()) <= max(cam.near, 1e-3) * 2.0:
        return None
    f = cam.focal
    px = cam.width / 2.0 + f * v[0] / depth
    py = cam.height / 2.0 - f * v[1] / depth
    x0 = max(0, int(np.floor(px.min())) - margin)
    x1 = min(cam.width, int(np.ceil(px.max())) + margin)
    y0 = max(0, int(np.floor(py.min())) - margin)
    y1 = min(cam.height, int(np.ceil(py.max())) + margin)
    if x1 <= x0 or y1 <= y0:
        return None
    cw = min(cam.width, -((x1 - x0) // -align_x) * align_x)
    x0 = max(0, min(x0, cam.width - cw))
    ch = min(cam.height, -((y1 - y0) // -align_y) * align_y)
    y0 = max(0, min(y0, cam.height - ch))
    if cw >= cam.width and ch >= cam.height:
        return None
    return (y0, x0, ch, cw)


def _t(v, like):
    return torch.tensor(np.asarray(v, np.float32), device=like.device).to(like.dtype)


def _div(a, b):
    return a / torch.tensor(float(np.float32(b)), dtype=a.dtype, device=a.device)


def _norm3(v):
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])


def _dot3(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cell_splats(pos, vel, mass, view: np.ndarray, cam: Cam) -> torch.Tensor:
    """[5, C]: per cell the valid slot of least depth (first in slot order
    on a tie): pixel x, pixel y, depth (CELL_BG for none), |vel|, count."""
    s = torch.cat([torch.from_numpy(view[:3, :4].reshape(-1).copy()),
                   torch.tensor([cam.focal, cam.width / 2.0, cam.height / 2.0, cam.near],
                                dtype=torch.float32)]).tolist()
    p, v = pos, vel.to(pos.dtype)
    vp = [s[4 * r] * p[0] + s[4 * r + 1] * p[1] + s[4 * r + 2] * p[2] + s[4 * r + 3]
          for r in range(3)]
    depth = -vp[2]
    safe = torch.where(depth > 1e-6, depth, _t(1e-6, depth))
    px = s[13] + s[12] * vp[0] / safe
    py = s[14] - s[12] * vp[1] / safe
    vmag = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    valid = (mass > 0) & (depth > s[15])
    dmask = torch.where(valid, depth, _t(CELL_BG, depth))
    dmin = torch.amin(dmask, dim=0)
    zero = torch.zeros_like(dmin)
    sel = [zero, zero, zero]
    found = torch.zeros_like(dmin, dtype=torch.bool)
    for k in range(mass.shape[0]):
        m = valid[k] & (dmask[k] == dmin) & ~found
        sel = [torch.where(m, x[k], y) for x, y in zip((px, py, vmag), sel)]
        found = found | m
    return torch.stack([sel[0], sel[1], torch.where(found, dmin, _t(CELL_BG, dmin)), sel[2],
                        valid.sum(dim=0).to(pos.dtype)])


def zbuffer(cells, crop, cam: Cam):
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    ix = torch.floor(cells[0]).to(torch.int64) - x0
    iy = torch.floor(cells[1]).to(torch.int64) - y0
    on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & (cells[2] < CELL_BG)
    pix = torch.where(on, iy * w + ix, h * w)
    d = torch.full((h * w + 1,), BG_DEPTH, dtype=cells.dtype, device=cells.device)
    d.scatter_reduce_(0, pix, torch.where(on, cells[2], _t(BG_DEPTH, cells)), reduce="amin")
    return d[:h * w].reshape(h, w)


def dilate(depth, cam: Cam, r: float = SPHERE_R, R: int = MAX_RADIUS_PX):
    """Each point grows into a disc of analytic sphere depth
    z - sqrt(r^2 - c Q), Q = max((z/f)^2, (r/R)^2), c = dx^2 + dy^2; the
    least offer wins, a centre pixel shows its sphere's pole."""
    h, w = depth.shape
    dev, dt = depth.device, depth.dtype
    f = torch.tensor(cam.focal, dtype=torch.float32, device=dev).to(dt)
    pad = max(R, 1)
    empty = depth >= BG_DEPTH
    d0 = F.pad(depth, (pad, pad, pad, pad), value=BG_DEPTH)
    q = torch.clamp_min((depth / f) ** 2, r * r / float(R * R))
    q = torch.where(empty, _t(float("inf"), depth), q)
    q0 = F.pad(q, (pad, pad, pad, pad), value=float("inf"))
    best = torch.where(~empty, depth - r, depth)
    dxs = torch.arange(R, -R - 1, -1, dtype=torch.float32, device=dev).to(dt)
    for dy in range(-R, R + 1):
        c = dxs * dxs + float(dy * dy)
        if dy == 0:
            c[R] = float("inf")
        win_d = d0[pad - dy:pad - dy + h].unfold(1, w, 1)[:, pad - R:pad + R + 1]
        win_q = q0[pad - dy:pad - dy + h].unfold(1, w, 1)[:, pad - R:pad + R + 1]
        cand = win_d - torch.sqrt(r * r - win_q * c[:, None])
        cand = torch.nan_to_num(cand, nan=float("inf"), posinf=float("inf"))
        best = torch.fmin(best, cand.amin(dim=1))
    return best


def blur_pass(depth, axis: int, proj_const: float, depth_threshold: float):
    dev, dt = depth.device, depth.dtype
    live = (depth > 0.0) & (depth <= FAR_GUARD)
    pc = torch.tensor(proj_const, dtype=torch.float32, device=dev).to(dt)
    fsize = torch.clamp_max(torch.ceil(pc / torch.clamp_min(depth, 1e-3)), float(MAX_FILTER))
    fsize = torch.clamp_max(fsize, float(MAX_FILTER))
    sigma = torch.clamp_min(fsize / _t(3.0, depth), 1e-3)
    inv_2ss2 = torch.reciprocal(2.0 * sigma * sigma)
    inv_2sr2 = float(np.float32(1.0 / (2.0 * depth_threshold * depth_threshold)))
    n = int(torch.where(live, fsize, _t(0.0, fsize)).max()) if depth.numel() else 0
    h, w = depth.shape
    pad = [0, 0, 0, 0]
    pad[2 * (1 - axis):2 * (1 - axis) + 2] = [n, n]
    dpad = F.pad(depth, pad, value=BG_DEPTH)

    def tap(off):
        return dpad[n + off:n + off + h, :] if axis == 0 else dpad[:, n + off:n + off + w]

    num, den = depth, torch.ones_like(depth)
    for k in range(1, n + 1):
        in_range = fsize >= float(k)
        ws = float(k * k) * inv_2ss2
        for s in (tap(-k), tap(k)):
            rd = s - depth
            wgt = torch.where(in_range, torch.exp(-(ws + (rd * rd) * inv_2sr2)), _t(0.0, rd))
            num = num + s * wgt
            den = den + wgt
    return torch.where(live, num / torch.clamp_min(den, 1e-9), depth)


def blur(depth, cam: Cam):
    """The X pass, then the Y pass; filter size min(100, ceil(pc / depth))."""
    pc = (BLUR_FILTER * SPHERE_R * 0.1 * (cam.height / 2.0)) / math.tan(
        math.radians(cam.fov_y_deg) / 2.0)
    bx = blur_pass(depth, 1, pc, SPHERE_R * BLUR_DEPTH_SCALE)
    return blur_pass(bx, 0, pc, SPHERE_R * BLUR_DEPTH_SCALE)


def _pixel_axes(cam: Cam, y0, x0, h, w, like):
    f = torch.tensor(cam.focal, dtype=torch.float32, device=like.device).to(like.dtype)
    xs = (torch.arange(w, dtype=torch.float32, device=like.device).to(like.dtype)
          + (0.5 + x0) - cam.width / 2.0) / f
    ys = -((torch.arange(h, dtype=torch.float32, device=like.device).to(like.dtype)
            + (0.5 + y0) - cam.height / 2.0) / f)
    return torch.meshgrid(xs, ys, indexing="xy")


def _ray_dirs(cam: Cam, crop, like):
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    xg, yg = _pixel_axes(cam, y0, x0, h, w, like)
    d = torch.stack([xg, yg, -torch.ones_like(xg)], dim=-1)
    return d / _norm3(d)[..., None]


def sky(dirs):
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)
    t = torch.clamp(y, 0.0, 1.0)[..., None]
    col = _t([0.75, 0.85, 0.95], dirs) * (1.0 - t) + _t([0.25, 0.45, 0.75], dirs) * t
    below = torch.clamp(-y, 0.0, 1.0)[..., None]
    col = col * (1.0 - below) + _t([0.35, 0.33, 0.3], dirs) * below
    sun = np.asarray([0.35, 0.65, 0.2], np.float32)
    sun = sun / np.linalg.norm(sun)
    s = torch.clamp(_div(_dot3(dirs, _t(sun, dirs)) - 0.998, 0.002), 0.0, 1.0)[..., None]
    return col + s * _t([6.0, 5.5, 4.5], dirs)


def background(cam: Cam, view: np.ndarray, like):
    """Ray-traced test scene: (color [H, W, 3], linear depth [H, W])."""
    v = _t(view, like)
    rot = v[:3, :3]
    eye = -(rot.T @ v[:3, 3])
    dirs_v = _ray_dirs(cam, None, like)
    dirs = dirs_v @ rot
    t_best = torch.full(dirs.shape[:2], float(np.float32(cam.far)), dtype=like.dtype,
                        device=like.device)
    c_best = sky(dirs)
    denom = dirs[..., 1]
    steep = torch.abs(denom) > 1e-6
    t_floor = (FLOOR_Y - eye[1]) / torch.where(steep, denom, _t(1e-6, denom))
    hit_f = (t_floor > 0) & steep
    p = eye + dirs * t_floor[..., None]
    check = torch.remainder(torch.floor(_div(p[..., 0], CHECKER))
                            + torch.floor(_div(p[..., 2], CHECKER)), 2.0) < 1.0
    fcol = torch.where(check[..., None], _t(FLOOR_A, dirs), _t(FLOOR_B, dirs))
    take = hit_f & (t_floor < t_best)
    t_best = torch.where(take, t_floor, t_best)
    c_best = torch.where(take[..., None], fcol, c_best)
    for center, radius, color in SPHERES:
        center = _t(center, dirs)
        oc = eye - center
        b = _dot3(dirs, oc)
        c = _dot3(oc, oc) - radius * radius
        disc = b * b - c
        t_hit = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = (disc > 0) & (t_hit > 0) & (t_hit < t_best)
        n = _div(eye + dirs * t_hit[..., None] - center, radius)
        lam = 0.35 + 0.65 * torch.clamp(n[..., 1], 0.0, 1.0)
        t_best = torch.where(hit, t_hit, t_best)
        c_best = torch.where(hit[..., None], _t(color, dirs) * lam[..., None], c_best)
    for lo, hi, color in BOXES:
        lo, hi = _t(lo, dirs), _t(hi, dirs)
        inv = torch.reciprocal(torch.where(torch.abs(dirs) > 1e-6, dirs, _t(1e-6, dirs)))
        t0, t1 = (lo - eye) * inv, (hi - eye) * inv
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit = (tmax > torch.clamp_min(tmin, 0.0)) & (tmin > 0) & (tmin < t_best)
        t_best = torch.where(hit, tmin, t_best)
        c_best = torch.where(hit[..., None], _t(color, dirs) * 0.85, c_best)
    return c_best, t_best * (-dirs_v[..., 2])


def _normals(depth, cam: Cam, crop):
    h, w = depth.shape
    y0, x0 = (crop[0], crop[1]) if crop is not None else (0, 0)
    xg, yg = _pixel_axes(cam, y0, x0, h, w, depth)
    vpos = torch.stack([xg * depth, yg * depth, -depth], dim=-1)

    def pick(axis):
        d1 = torch.roll(vpos, -1, dims=axis) - vpos
        d2 = -(torch.roll(vpos, 1, dims=axis) - vpos)
        return torch.where((torch.abs(d1[..., 2]) > torch.abs(d2[..., 2]))[..., None], d2, d1)

    a, b = pick(0), pick(1)
    n = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)
    return n / torch.clamp_min(_norm3(n), 1e-9)[..., None]


def shade(depth, bg_color, bg_depth, view: np.ndarray, cam: Cam, crop):
    """Colour of the crop (the full frame for None) over the background."""
    dev = depth.device
    y0, x0 = (crop[0], crop[1]) if crop is not None else (0, 0)
    h, w = depth.shape
    bg_d = bg_depth[y0:y0 + h, x0:x0 + w]
    bg_c = bg_color[y0:y0 + h, x0:x0 + w]
    live = (depth <= FAR_GUARD) & (bg_d >= depth)
    normal = _normals(depth, cam, crop)
    ray = _ray_dirs(cam, crop, depth)
    rot = _t(view, depth)[:3, :3]
    light = rot @ _t(LIGHT_DIR, depth)
    light = -light / torch.clamp_min(_norm3(light), 1e-9)
    hv = light - ray
    hv = hv / torch.clamp_min(_norm3(hv), 1e-9)[..., None]
    spec = torch.pow(torch.clamp_min(_dot3(hv, normal), 0.0), SPECULAR_POWER)
    cos_t = _dot3(normal, -ray)
    fres = torch.clamp(F0 + (1.0 - F0) * torch.pow(torch.clamp_min(1.0 - cos_t, 0.0), 5.0),
                       0.0, FRESNEL_CLAMP)
    refl = sky((ray - 2.0 * cos_t[..., None] * (-normal)) @ rot)
    cos_i = torch.clamp(_dot3(-ray, normal), -1.0, 1.0)
    k = 1.0 - ETA * ETA * (1.0 - cos_i * cos_i)
    refr = ETA * ray + (ETA * cos_i - torch.sqrt(torch.clamp_min(k, 0.0)))[..., None] * normal
    uv = refr[..., :2] * (THICKNESS * REFRACTION)
    fw, fh = cam.width, cam.height
    xs = torch.arange(w, dtype=torch.float32, device=dev).to(depth.dtype) + float(x0)
    ys = torch.arange(h, dtype=torch.float32, device=dev).to(depth.dtype) + float(y0)
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    # clamped again as integers: in bfloat16 the clamp's top fw - 1 rounds up
    sx = torch.clamp(torch.clamp(xg + uv[..., 0] * fw, 0, fw - 1).to(torch.int64), 0, fw - 1)
    sy = torch.clamp(torch.clamp(yg - uv[..., 1] * fh, 0, fh - 1).to(torch.int64), 0, fh - 1)
    transmitted = bg_color.reshape(-1, 3)[sy * fw + sx]
    trans = torch.exp(-OPTICAL_DENSITY * (1.0 - _t(DIFFUSE, depth)) * THICKNESS)
    color = (transmitted * trans * (1.0 - fres[..., None]) + refl * fres[..., None]
             + spec[..., None])
    return torch.where(live[..., None], color, bg_c)


def to_u8(img):
    g = torch.pow(torch.clamp(img, 0.0, 1.0), float(np.float32(1.0 / 2.2)))
    return (g * 255.0 + 0.5).to(torch.uint8)


def frame(pos, vel, mass, view: np.ndarray, cam: Cam, crop, bg) -> torch.Tensor:
    """The u8 frame [H, W, 3] of the bucket arrays (pos, vel, mass) under a
    static `view`; `bg` is background()'s pair for that view."""
    cells = cell_splats(pos, vel, mass, view, cam)
    depth = blur(dilate(zbuffer(cells, crop, cam), cam), cam)
    color = shade(depth, bg[0], bg[1], view, cam, crop)
    if crop is not None:
        y0, x0, ch, cw = crop
        full = bg[0].clone()
        full[y0:y0 + ch, x0:x0 + cw] = color
        color = full
    return to_u8(color)
