"""Shared inputs of the shade tests: kernel SH against its plain version on
the card (tests/test_torch_cuda.py) and the wrapper's plain path on the CPU
(tests/test_torch_render_kernels.py). No JAX import.

A case is shade_kernel's keyword arguments: a seeded depth buffer (a wavy
fluid surface at depth 40-55 with noise and holes, the background's depth
4000 around it), the background of render_background for the default view
of a 16^3 grid, and the case's parameters. On the card the frame is the
benchmark cell's 1920x1080 with its crop (88, 483, 992, 1024); on the CPU a
160x96 frame with a crop of the same kind."""

import numpy as np
import torch

from mpm_tpu_torch.render import Camera, SSFRParams, default_view
from mpm_tpu_torch.render.background import render_background
from mpm_tpu_torch.render.splat import BG_DEPTH

SHADE_CASES = ("crop", "full", "thickness", "cubemap", "downsample", "edges")


def shade_case(case: str, device, full_size: bool) -> dict:
    """shade_kernel's keyword arguments for `case`: "crop" (the constant
    thickness and the sky), "full" (no crop), "thickness" (a per-pixel
    map), "cubemap" (random faces of 16 texels), "downsample"
    (refraction_downsample 4) and "edges" (fluid over the whole crop, so the
    normals of its edge pixels wrap to the opposite edge)."""
    if full_size:
        cam, crop = Camera(width=1920, height=1080), (88, 483, 992, 1024)
    else:
        cam, crop = Camera(width=160, height=96), (8, 24, 64, 112)
    if case == "full":
        crop = None
    h, w = (crop[2], crop[3]) if crop is not None else (cam.height, cam.width)
    rng = np.random.default_rng(sum(map(ord, case)))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (45.0 + 6.0 * np.sin(xx / (w / 7.0)) * np.cos(yy / (h / 5.0))
             + rng.uniform(-0.3, 0.3, (h, w))).astype(np.float32)
    if case != "edges":
        inside = ((yy - h / 2) / (0.4 * h)) ** 2 + ((xx - w / 2) / (0.4 * w)) ** 2 < 1.0
        depth[~inside] = BG_DEPTH
    depth[rng.uniform(size=(h, w)) < 0.02] = BG_DEPTH
    view = default_view((16, 16, 16))
    bg_color, bg_depth = render_background(cam, view, device=device)
    params = SSFRParams(refraction_downsample=4 if case == "downsample" else 1)
    thickness = faces = None
    if case == "thickness":
        thickness = torch.from_numpy(rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)).to(device)
    if case == "cubemap":
        faces = torch.from_numpy(rng.uniform(0.0, 1.0, (6, 16, 16, 3)).astype(np.float32)).to(
            device)
    return dict(fluid_depth=torch.from_numpy(depth).to(device), bg_color=bg_color,
                bg_depth=bg_depth, cubemap_faces=faces, view=view, params=params, cam=cam,
                thickness=thickness, crop=crop)
