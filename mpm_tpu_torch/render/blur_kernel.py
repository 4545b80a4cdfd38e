"""Kernel BL: the depth-adaptive separable bilateral blur of the SSFR depth
buffer in hand-written CUDA (csrc/blur_depth.cu), beside its plain PyTorch
version (port of ``mpm_tpu.render.blur_kernel``).

Filter size shrinks with depth: min(max_filter, ceil(proj_const / depth),
radius); Gaussian space weights (sigma = size / 3) times Gaussian range
weights (sigma = depth_threshold), one exponential per tap, taps at -k then
+k for k = 1..size, the X pass then the Y pass. Taps outside the image read
BG_DEPTH; pixels that are not fluid (depth <= 0 or > FAR_GUARD) pass
through. The port has one semantics at every shape and on every device:
radius `max_filter_size` (the JAX package's CPU path caps it at
`blur_tap_radius`, its TPU kernel does not).

`blur_depth_kernel(...)` takes the plain version for a buffer on the CPU
and launches kernel BL for a buffer on a CUDA device; there is no other
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.cuda import build
from .camera import Camera

FAR_GUARD = 3990.0  # ssfr.FAR_GUARD (the reference's far-plane guard)
BG_DEPTH = 4000.0  # splat.BG_DEPTH (the padding's value)

launches = 0  # kernel launches by blur_depth_kernel (plain calls not counted)


def proj_const_for(cam: Camera, blur_filter_size: float) -> float:
    """The projected particle constant (screen_space_fluid_rendering.gd:
    373-376): blur_filter_size * 0.1 * (h/2) / tan(fov/2); the caller folds
    the sphere radius into blur_filter_size."""
    return (blur_filter_size * 0.1 * (cam.height / 2.0)) / math.tan(
        math.radians(cam.fov_y_deg) / 2.0)


def _inv_2sr2(depth_threshold: float) -> float:
    return float(np.float32(1.0 / (2.0 * depth_threshold * depth_threshold)))


def filter_sizes(depth: torch.Tensor, radius: int, max_filter: int,
                 proj_const: float) -> torch.Tensor:
    """Per-pixel filter size (float) of one pass, as the kernel computes it:
    min(max_filter, ceil(proj_const / max(d, 1e-3)), radius)."""
    pc = torch.tensor(proj_const, dtype=torch.float32, device=depth.device)
    fsize = torch.clamp_max(torch.ceil(pc / torch.clamp_min(depth, 1e-3)), float(max_filter))
    return torch.clamp_max(fsize, float(radius))


def blur_pass_plain(depth: torch.Tensor, axis: int, radius: int, max_filter: int,
                    proj_const: float, depth_threshold: float) -> torch.Tensor:
    """One directional pass (axis 1 = X, 0 = Y) in plain PyTorch. It loops
    to the largest live filter size; a tap past a pixel's own size gets
    weight exactly 0 and adds exact zeros, so each pixel sums what the
    kernel sums, in the kernel's order."""
    live = (depth > 0.0) & (depth <= FAR_GUARD)
    fsize = filter_sizes(depth, radius, max_filter, proj_const)
    three = torch.tensor(3.0, dtype=torch.float32, device=depth.device)
    sigma = torch.clamp_min(fsize / three, 1e-3)
    inv_2ss2 = torch.reciprocal(2.0 * sigma * sigma)
    inv_2sr2 = _inv_2sr2(depth_threshold)
    n = int(torch.where(live, fsize, 0.0).max()) if depth.numel() else 0
    h, w = depth.shape
    pad = [0, 0, 0, 0]
    pad[2 * (1 - axis):2 * (1 - axis) + 2] = [n, n]
    dpad = torch.nn.functional.pad(depth, pad, value=BG_DEPTH)

    def tap(off):
        return dpad[n + off:n + off + h, :] if axis == 0 else dpad[:, n + off:n + off + w]

    num, den = depth, torch.ones_like(depth)
    for k in range(1, n + 1):
        in_range = fsize >= float(k)
        ws = float(k * k) * inv_2ss2
        for s in (tap(-k), tap(k)):
            rd = s - depth
            wgt = torch.where(in_range, torch.exp(-(ws + (rd * rd) * inv_2sr2)), 0.0)
            num = num + s * wgt
            den = den + wgt
    return torch.where(live, num / torch.clamp_min(den, 1e-9), depth)


def blur_depth_plain(depth: torch.Tensor, cam: Camera, radius: int, max_filter: int,
                     blur_filter_size: float, depth_threshold: float) -> torch.Tensor:
    """Both passes of the blur in plain PyTorch (the X pass, then Y)."""
    pc = proj_const_for(cam, blur_filter_size)
    bx = blur_pass_plain(depth, 1, radius, max_filter, pc, depth_threshold)
    return blur_pass_plain(bx, 0, radius, max_filter, pc, depth_threshold)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("blur_depth")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.blur_depth.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, cf, vp]
    lib.blur_depth.restype = ci
    return lib


def blur_depth_kernel(depth: torch.Tensor, cam: Camera, radius: int, max_filter: int,
                      blur_filter_size: float, depth_threshold: float) -> torch.Tensor:
    """Both passes of the depth-adaptive bilateral blur of an [H, W] float32
    linear-depth buffer: the plain version on the CPU, kernel BL on CUDA.
    The arguments are those of the JAX package's blur_depth_pallas."""
    global launches
    dev = depth.device
    if dev.type == "cpu":
        return blur_depth_plain(depth, cam, radius, max_filter, blur_filter_size,
                                depth_threshold)
    if dev.type != "cuda":
        raise ValueError(f"kernel BL runs on CUDA devices, not {dev}")
    if depth.dim() != 2 or depth.dtype != torch.float32 or not depth.is_contiguous():
        raise ValueError("depth must be a contiguous float32 [H, W] tensor")
    h, w = depth.shape
    tmp, out = torch.empty_like(depth), torch.empty_like(depth)
    lib = _lib()
    P = build.ptr
    with torch.cuda.device(dev):
        rc = lib.blur_depth(P(depth), P(tmp), P(out), h, w, int(radius), int(max_filter),
                            proj_const_for(cam, blur_filter_size),
                            _inv_2sr2(depth_threshold), build.stream_of(dev))
    build.check_rc("blur_depth", rc)
    launches += 1
    return out
