"""The splat kernels: the z-buffer of the splat points (or their velocity
key) and the sphere dilation, in hand-written CUDA (csrc/splat_dilate.cu),
beside their plain PyTorch versions (render/splat.zbuffer_cells_plain,
velocity_key_plain, buffers_from_zbuffer_plain and _dilate_spheres).

They replace no TPU kernel: the JAX package's splat pass is plain jnp. On
the card the plain dilation is some 134 launches a 1080p frame, each writing
a full [h, 2R+1, w] intermediate, and a blocking upload of the focal
length; here the z-buffer is a fill and one atomic-min scatter, and the
dilation one launch, a thread a pixel, whose constants (focal length, r,
r^2, r^2 / R^2, 1 / r, R) are float32 values computed on the host from the
camera and the call's arguments and passed by value.

render/splat.py's `zbuffer_cells`, `velocity_key`, `buffers_from_zbuffer`
and `splat_particles` take the plain versions for tensors on the CPU and
these kernels for tensors on a CUDA device; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda.extract_cells import CELL_BG
from .camera import Camera

MAX_RADIUS_PX = 75  # the largest splat radius whose tile and halo fit in shared memory

zbuffer_launches = 0  # calls of splat_zbuffer (a fill and a scatter): z-buffers and keys
dilate_launches = 0  # launches of the dilation

_ci, _cf, _vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("splat_dilate")
    lib.splat_zbuffer.argtypes = [_vp] + [_ci] * 6 + [_cf, _ci, _vp, _vp]
    lib.splat_dilate.argtypes = [_vp] * 7 + [_ci] * 4 + [_cf] * 5 + [_ci, _ci, _vp]
    lib.splat_dilate_smem.argtypes = [_ci]
    lib.splat_dilate_max_smem.argtypes = []
    for fn in (lib.splat_zbuffer, lib.splat_dilate, lib.splat_dilate_smem,
               lib.splat_dilate_max_smem):
        fn.restype = _ci
    if not (lib.splat_dilate_smem(MAX_RADIUS_PX) <= lib.splat_dilate_max_smem()
            < lib.splat_dilate_smem(MAX_RADIUS_PX + 1)):
        raise RuntimeError("csrc/splat_dilate.cu's tile and splat_kernel.MAX_RADIUS_PX differ")
    return lib


def _on_card(t: torch.Tensor, kernel: str) -> torch.device:
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"the splat kernel's {kernel} runs on CUDA devices, not {dev}")
    return dev


def _check(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on {dev}")


def zbuffer(cells: torch.Tensor, cam: Camera, crop=None, key: bool = False) -> torch.Tensor:
    """The z-buffer [H, W] float32 of splat points [5, M] (with `key`, the
    velocity key [H, W] int32) on the frame or the crop (y0, x0, ch, cw):
    splat.zbuffer_cells_plain's (velocity_key_plain's) bits, one fill and
    one scatter launch. The points' rows may lie apart (a column slice, as
    a slab's own splats are); each row is contiguous."""
    global zbuffer_launches
    dev = _on_card(cells, "z-buffer")
    if (cells.dim() != 2 or cells.shape[0] != 5 or cells.dtype != torch.float32
            or (cells.shape[1] > 1 and cells.stride(1) != 1)):
        raise ValueError(f"cells must be float32 [5, M] rows, each contiguous, on {dev}")
    m = cells.shape[1]
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    out = torch.empty((h, w), dtype=torch.int32 if key else torch.float32, device=dev)
    with build.on_device(dev):
        rc = _lib().splat_zbuffer(cells.data_ptr(), m, cells.stride(0), y0, x0, h, w, CELL_BG,
                                  int(key), out.data_ptr(), build.stream_of(dev))
    build.check_rc("splat_zbuffer", rc)
    zbuffer_launches += 1
    return out


def dilate_constants(cam: Camera, sphere_radius: float, max_radius_px: int) -> tuple:
    """The dilation's float32 constants (focal, r, r^2, r^2 / R^2, 1 / r),
    rounded from the Python values as the plain version's operations round
    them: the focal length as its device tensor, the scalars as PyTorch
    casts a Python float operand."""
    R = max_radius_px
    r2 = sphere_radius * sphere_radius
    return tuple(float(np.float32(v)) for v in (
        cam.focal_px, sphere_radius, r2, r2 / float(R * R) if R else 1.0, 1.0 / sphere_radius))


def dilate(depth: torch.Tensor, cam: Camera, sphere_radius: float, max_radius_px: int,
           velocity: torch.Tensor | None = None, key: torch.Tensor | None = None,
           raw: bool = False, with_velocity: bool = False, with_normals: bool = False):
    """The sphere dilation of an [H, W] depth buffer in one launch: (depth,
    velocity or None, sx or None, sy or None), splat._dilate_spheres's bits.
    With `raw` the depth is a z-buffer as zbuffer gives it, decoded as
    splat.buffers_from_zbuffer_plain decodes it, and a tracked velocity
    comes from `key`; else it comes from `velocity`."""
    global dilate_launches
    dev = _on_card(depth, "dilation")
    R = int(max_radius_px)
    if not 0 <= R <= MAX_RADIUS_PX:
        raise ValueError(f"the splat kernel dilates radii 0 to {MAX_RADIUS_PX} pixels, not {R}")
    if depth.dim() != 2:
        raise ValueError("depth must be an [H, W] tensor")
    h, w = depth.shape
    _check("depth", depth, (h, w), torch.float32, dev)
    src = None  # the tracked velocity's source: the key (raw) or the velocity
    if with_velocity:
        src = key if raw else velocity
        if src is None:
            raise ValueError("a tracked velocity needs `key` (raw) or `velocity`")
        _check("key" if raw else "velocity", src, (h, w), torch.int32 if raw else torch.float32,
               dev)
    out = torch.empty((1 + int(with_velocity) + 2 * int(with_normals), h, w), dtype=torch.float32,
                      device=dev)
    v = out[1] if with_velocity else None
    sx, sy = (out[-2], out[-1]) if with_normals else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with build.on_device(dev):
        rc = _lib().splat_dilate(
            depth.data_ptr(), None if raw else ptr(src), ptr(src) if raw else None,
            out.data_ptr(), ptr(v), ptr(sx), ptr(sy), h, w, R, int(raw),
            *dilate_constants(cam, sphere_radius, R), int(with_velocity), int(with_normals),
            build.stream_of(dev))
    build.check_rc("splat_dilate", rc)
    dilate_launches += 1
    return out[0], v, sx, sy
