"""Kernel SH: the default mode's SSFR shade pass, composited into the full
frame, in hand-written CUDA (csrc/ssfr_shade.cu), beside its plain PyTorch
version (render/ssfr.shade and the crop's composite over the background).

It replaces no TPU kernel: the JAX package's shade is plain jnp. On the
card the plain version is some 170 small ops a frame and the uploads of its
constants, bound by the host's launch rate; the kernel is one launch, and
every constant of the pass (the view's rotation, the light, the focal
length, the crop, the sky, the absorption) is built once for each view,
camera, parameters and crop (`shade_args`) and passed by value.

`shade_kernel(...)` takes the plain version for buffers on the CPU and
launches kernel SH for buffers on a CUDA device; there is no other
fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda.extract_cells import render_scals_for
from . import background
from .background import make_cubemap_sampler
from .camera import Camera
from .ssfr import ETA, F0, SSFRParams, shade

launches = 0  # kernel launches by shade_kernel (plain calls not counted)

_ci, _cf = ctypes.c_int, ctypes.c_float


class ShadeArgs(ctypes.Structure):
    """The scalar arguments of kernel SH (csrc/ssfr_shade.cu ShadeArgs),
    float32 values as the plain version rounds them."""

    _fields_ = [("fh", _ci), ("fw", _ci), ("y0", _ci), ("x0", _ci), ("h", _ci), ("w", _ci),
                ("ds", _ci), ("faces", _ci),
                ("focal", _cf), ("ox", _cf), ("oy", _cf), ("half_w", _cf), ("half_h", _cf),
                ("rot", _cf * 9), ("light", _cf * 3),
                ("spec_power", _cf), ("fresnel_clamp", _cf), ("f0", _cf), ("one_minus_f0", _cf),
                ("eta", _cf), ("eta2", _cf), ("uv_scale", _cf), ("refr_strength", _cf),
                ("thickness", _cf), ("absorb", _cf * 3), ("horizon", _cf * 3),
                ("zenith", _cf * 3), ("ground", _cf * 3), ("sun_dir", _cf * 3),
                ("sun_color", _cf * 3), ("sun_cos", _cf), ("sun_width", _cf)]


def shade_plain(fluid_depth: torch.Tensor, bg_color: torch.Tensor, bg_depth: torch.Tensor,
                cubemap_faces, view, params: SSFRParams, cam: Camera,
                thickness: torch.Tensor | None = None, crop=None):
    """The plain version: ssfr.shade, its crop composited over the full
    background. Returns (color [H, W, 3], live [h, w]) as shade_kernel."""
    color, live = shade(fluid_depth, bg_color, bg_depth, make_cubemap_sampler(cubemap_faces),
                        view, params, cam, thickness=thickness, crop=crop)
    if crop is not None:
        y0, x0, ch, cw = crop
        full = bg_color.clone()
        full[y0:y0 + ch, x0:x0 + cw] = color
        color = full
    return color, live


def _f32(x) -> np.float32:
    return np.float32(x)


def _light_view(rot: np.ndarray, light_dir) -> np.ndarray:
    """ssfr.shade's view-space light vector, -(rot @ l) / max(|rot @ l|,
    1e-9), in float32, each sum left to right."""
    l = np.asarray(light_dir, np.float32)
    lv = [(rot[i, 0] * l[0] + rot[i, 1] * l[1]) + rot[i, 2] * l[2] for i in range(3)]
    n = max(np.sqrt((lv[0] * lv[0] + lv[1] * lv[1]) + lv[2] * lv[2]), _f32(1e-9))
    return np.asarray([-v / n for v in lv], np.float32)


_args_cache: dict = {}  # (id(scals), params, crop, shape, faces) -> (scals, ShadeArgs)


def shade_args(view, cam: Camera, params: SSFRParams, crop, shape: tuple[int, int],
               faces: int = 0) -> ShadeArgs:
    """Kernel SH's arguments for a view, camera, parameters, crop (or None),
    depth buffer shape and cubemap face size (0: the procedural sky).

    Built once: the view's rotation comes from extract_cells.render_scals_for,
    which gives the same tensor back while the view is unchanged, so an
    unchanged view gets the same arguments back with nothing computed; a
    view changed in place, or another camera, parameters or crop, builds
    anew."""
    scals = render_scals_for(view, cam)
    key = (id(scals), params, crop, shape, faces)
    hit = _args_cache.get(key)
    if hit is not None and hit[0] is scals:
        return hit[1]
    h, w = shape
    y0, x0 = (crop[0], crop[1]) if crop is not None else (0, 0)
    rot = scals[:12].numpy().reshape(3, 4)[:, :3]
    diffuse = np.asarray(params.diffuse_color, np.float32)
    a = ShadeArgs(fh=cam.height, fw=cam.width, y0=y0, x0=x0, h=h, w=w,
                  ds=int(params.refraction_downsample), faces=faces,
                  focal=_f32(cam.focal_px), ox=_f32(0.5 + x0), oy=_f32(0.5 + y0),
                  half_w=_f32(cam.width / 2.0), half_h=_f32(cam.height / 2.0),
                  spec_power=_f32(params.specular_power),
                  fresnel_clamp=_f32(params.fresnel_clamp), f0=_f32(F0),
                  one_minus_f0=_f32(1.0 - F0), eta=_f32(ETA), eta2=_f32(ETA * ETA),
                  uv_scale=_f32(params.thickness * params.refraction_strength),
                  refr_strength=_f32(params.refraction_strength),
                  thickness=_f32(params.thickness),
                  sun_cos=_f32(background.SUN_COS), sun_width=_f32(background.SUN_WIDTH))
    a.rot[:] = rot.reshape(-1).tolist()
    a.light[:] = _light_view(rot, params.light_dir).tolist()
    a.absorb[:] = (_f32(-params.optical_density) * (_f32(1.0) - diffuse)).tolist()
    for name, v in (("horizon", background.SKY_HORIZON), ("zenith", background.SKY_ZENITH),
                    ("ground", background.SKY_GROUND), ("sun_dir", background.SUN_DIR),
                    ("sun_color", background.SUN_COLOR)):
        getattr(a, name)[:] = np.asarray(v, np.float32).tolist()
    if len(_args_cache) >= 64:
        _args_cache.clear()
    _args_cache[key] = (scals, a)  # holds scals: its id stays its own
    return a


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssfr_shade")
    vp = ctypes.c_void_p
    lib.ssfr_shade.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.ssfr_shade.restype = _ci
    lib.ssfr_shade_args_bytes.argtypes, lib.ssfr_shade_args_bytes.restype = [], _ci
    if lib.ssfr_shade_args_bytes() != ctypes.sizeof(ShadeArgs):
        raise RuntimeError("csrc/ssfr_shade.cu's ShadeArgs and shade_kernel.ShadeArgs differ")
    return lib


def _check(name: str, t: torch.Tensor, shape, dev) -> None:
    if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {list(shape)} tensor on {dev}")


def shade_kernel(fluid_depth: torch.Tensor, bg_color: torch.Tensor, bg_depth: torch.Tensor,
                 cubemap_faces, view, params: SSFRParams, cam: Camera,
                 thickness: torch.Tensor | None = None, crop=None):
    """The default mode's shade of a blurred depth buffer, composited over
    the background: the plain version on the CPU, kernel SH on CUDA.
    `bg_color` [H, W, 3] and `bg_depth` [H, W] are full-frame; under `crop`
    = (y0, x0, ch, cw) the depth and the thickness map (or None: the
    constant thickness) are crop-sized. `cubemap_faces`: [6, F, F, 3] or
    None for the procedural sky. Returns (color [H, W, 3], live [h, w])."""
    global launches
    dev = fluid_depth.device
    if dev.type == "cpu":
        return shade_plain(fluid_depth, bg_color, bg_depth, cubemap_faces, view, params, cam,
                           thickness=thickness, crop=crop)
    if dev.type != "cuda":
        raise ValueError(f"kernel SH runs on CUDA devices, not {dev}")
    fh, fw = cam.height, cam.width
    h, w = (crop[2], crop[3]) if crop is not None else (fh, fw)
    _check("fluid_depth", fluid_depth, (h, w), dev)
    _check("bg_color", bg_color, (fh, fw, 3), dev)
    _check("bg_depth", bg_depth, (fh, fw), dev)
    if thickness is not None:
        _check("thickness", thickness, (h, w), dev)
    nf = 0
    if cubemap_faces is not None:
        nf = cubemap_faces.shape[1]
        _check("cubemap_faces", cubemap_faces, (6, nf, nf, 3), dev)
    args = shade_args(view, cam, params, crop, (h, w), nf)
    out = torch.empty((fh, fw, 3), dtype=torch.float32, device=dev)
    live = torch.empty((h, w), dtype=torch.bool, device=dev)
    with build.on_device(dev):
        rc = _lib().ssfr_shade(
            fluid_depth.data_ptr(), bg_color.data_ptr(), bg_depth.data_ptr(),
            None if thickness is None else thickness.data_ptr(),
            None if cubemap_faces is None else cubemap_faces.data_ptr(),
            out.data_ptr(), live.data_ptr(), ctypes.addressof(args), build.stream_of(dev))
    build.check_rc("ssfr_shade", rc)
    launches += 1
    return out, live
