"""Camera model of the headless renderer (port of ``mpm_tpu.render.camera``).

Everything stays in view space: +x right, +y up, the camera looks down -z,
and "linear depth" is -z_view. Pixel origin is top-left with y down, the
image storage order. A view matrix is a [4, 4] float32 world->view matrix;
the port keeps it on the host (a CPU tensor or numpy array) and moves it to
the device where an image needs it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: fov_y in degrees, image size (width, height)."""

    width: int = 1280
    height: int = 720
    fov_y_deg: float = 75.0
    near: float = 0.05
    far: float = 4000.0

    @property
    def focal_px(self) -> float:
        """Pixels per unit tan: (height/2) / tan(fov/2)."""
        return (self.height / 2.0) / math.tan(math.radians(self.fov_y_deg) / 2.0)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World->view rotation+translation matrix [4, 4] (right-handed, -z fwd)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    rot = np.stack([right, true_up, -fwd])  # rows: view axes
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view


def as_view(view, device=None) -> torch.Tensor:
    """A view matrix as a float32 tensor on `device` (default: the CPU)."""
    if not isinstance(view, torch.Tensor):
        view = torch.from_numpy(np.array(view, np.float32))
    return view.to(device=device, dtype=torch.float32)


def world_to_view(pos: torch.Tensor, view) -> torch.Tensor:
    """[3, N] world -> view coordinates: view[:3, :3] @ pos + view[:3, 3]."""
    v = as_view(view, pos.device)
    return v[:3, :3] @ pos + v[:3, 3][:, None]


def view_to_screen(view_pos: torch.Tensor, cam: Camera):
    """View-space [3, N] -> (pixel x, pixel y, linear depth), each [N]."""
    depth = -view_pos[2]
    safe = torch.where(depth > 1e-6, depth, 1e-6)
    f = cam.focal_px
    px = cam.width / 2.0 + f * view_pos[0] / safe
    py = cam.height / 2.0 - f * view_pos[1] / safe
    return px, py, depth


def _pixel_axes(cam: Camera, y0: int, x0: int, h: int, w: int, device):
    """Per-column and per-row tan offsets of the pixel centres of a
    sub-rectangle, in full-frame coordinates."""
    f = torch.tensor(cam.focal_px, dtype=torch.float32, device=device)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + (0.5 + x0)
          - cam.width / 2.0) / f
    ys = -((torch.arange(h, dtype=torch.float32, device=device) + (0.5 + y0)
            - cam.height / 2.0) / f)
    return torch.meshgrid(xs, ys, indexing="xy")


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed left to right."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def screen_to_view_dir(cam: Camera, crop=None, device=None) -> torch.Tensor:
    """Per-pixel unit ray direction in view space, [H, W, 3]. `crop` =
    (y0, x0, ch, cw): rays of that sub-rectangle only; pixel centres keep
    their full-frame coordinates."""
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    xg, yg = _pixel_axes(cam, y0, x0, h, w, device)
    d = torch.stack([xg, yg, -torch.ones_like(xg)], dim=-1)
    return d / norm3(d)[..., None]


def view_pos_from_depth(cam: Camera, linear_depth: torch.Tensor,
                        crop=None) -> torch.Tensor:
    """View-space position [H, W, 3] from per-pixel linear depth [H, W];
    `crop` = (y0, x0, ch, cw) when the depth is a sub-rectangle."""
    h, w = linear_depth.shape
    y0, x0 = (crop[0], crop[1]) if crop is not None else (0, 0)
    xg, yg = _pixel_axes(cam, y0, x0, h, w, linear_depth.device)
    return torch.stack([xg * linear_depth, yg * linear_depth, -linear_depth], dim=-1)


def crop_for_aabb(cam: Camera, view, lo, hi, margin: int = 16,
                  align_x: int = 128, align_y: int = 8):
    """Conservative static screen crop (y0, x0, ch, cw) of a world AABB, or
    None when cropping buys nothing (the projection covers the frame) or is
    unsafe (a corner at or behind the near plane).

    The whole box strictly in front of the camera projects inside the hull
    of its projected corners, so the corner bbox plus `margin` (the
    dilation radius and the normals' 1-pixel reach) bounds every fluid
    pixel: positions are clamped to the domain. Widths round up to
    `align_x` and heights to `align_y`, as the JAX package aligns them, so
    the two packages crop the same rectangle."""
    view = np.asarray(view, np.float32)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])], np.float32)
    v = view[:3, :3] @ corners.T + view[:3, 3][:, None]
    depth = -v[2]
    if float(depth.min()) <= max(cam.near, 1e-3) * 2.0:
        return None
    f = cam.focal_px
    px = cam.width / 2.0 + f * v[0] / depth
    py = cam.height / 2.0 - f * v[1] / depth
    x0 = max(0, int(np.floor(px.min())) - margin)
    x1 = min(cam.width, int(np.ceil(px.max())) + margin)
    y0 = max(0, int(np.floor(py.min())) - margin)
    y1 = min(cam.height, int(np.ceil(py.max())) + margin)
    if x1 <= x0 or y1 <= y0:  # box fully offscreen
        return None
    cw = min(cam.width, -((x1 - x0) // -align_x) * align_x)
    x0 = max(0, min(x0, cam.width - cw))
    ch = min(cam.height, -((y1 - y0) // -align_y) * align_y)
    y0 = max(0, min(y0, cam.height - ch))
    if cw >= cam.width and ch >= cam.height:
        return None
    return (y0, x0, ch, cw)
