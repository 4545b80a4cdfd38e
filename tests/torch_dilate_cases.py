"""Shared inputs of the splat-kernel tests: the z-buffer, the velocity key
and the sphere dilation against their plain versions on the card
(tests/test_torch_cuda.py) and the wrappers' plain path and the kernel's
tap walk on the CPU (tests/test_torch_splat_kernel.py). No JAX import.

A case is a dict: seeded splat points `cells` [5, M] (pixel x, pixel y,
depth, |vel|, count; a fifth of them empty, depth 1e9), the camera, the
crop (or None), the splat radius R, the sphere radius, which attributes the
dilation tracks, and the number of slabs whose z-buffers are composited
with a min (1: none). "particles" draws a particle array through
splat_particles instead (`pos` [3, N], `vel` [N], `view`)."""

import numpy as np
import torch

from mpm_tpu_torch.render import Camera, default_view

DILATE_CASES = ("crop", "full", "r6_360", "r8_360", "velocity", "lit", "tie", "empty", "near",
                "sharded", "particles")


def tie_cells() -> np.ndarray:
    """Splat points whose discs offer equal depths at one pixel of a 128 x
    128 frame: a pair along a row (pixel (20, 32)), a pair along a column
    (pixel (52, 60)), four on a square's corners (pixel (80, 80)) and a flat
    10 x 10 patch. Columns: (x, y, velocity)."""
    pts = [(30, 20, 1.0), (34, 20, 2.0), (60, 50, 3.0), (60, 54, 4.0),
           (78, 78, 5.0), (82, 78, 6.0), (78, 82, 7.0), (82, 82, 8.0)]
    rng = np.random.default_rng(5)
    pts += [(x, y, float(rng.uniform(0, 60))) for y in range(100, 110) for x in range(10, 20)]
    p = np.asarray(pts, np.float32)
    return np.stack([p[:, 0] + 0.5, p[:, 1] + 0.5, np.full(len(p), 20.0, np.float32), p[:, 2],
                     np.ones(len(p), np.float32)])


def _cells(rng, x0, y0, w, h, m, zlo, zhi) -> np.ndarray:
    """m seeded points over the rectangle (x0, y0, w, h) and 5 pixels
    around it, depths in [zlo, zhi), a fifth empty."""
    c = np.stack([rng.uniform(x0 - 5, x0 + w + 5, m), rng.uniform(y0 - 5, y0 + h + 5, m),
                  rng.uniform(zlo, zhi, m), rng.uniform(0, 80, m),
                  rng.integers(1, 9, m)]).astype(np.float32)
    c[2, rng.random(m) < 0.2] = 1e9
    return c


def dilate_case(case: str, device, full_size: bool) -> dict:
    """The inputs of `case`: "crop" (the benchmark cell's 1920x1080 crop
    (88, 483, 992, 1024), R 6, depth only), "full" (the whole 1080p frame),
    "r6_360" and "r8_360" (640x360 at R 6 and 8), "velocity" and "lit" (the
    key and the tracked velocity, with the normals for lit), "tie" (the
    tracking tie rule: tie_cells at 128x128, R 3), "empty" (no point on the
    buffer), "near" (a patch at depth 2-3, whose discs reach the clamp r^2 /
    R^2, beside far points), "sharded" (the lit mode's buffers as the min of
    2 slabs' z-buffers and keys) and "particles" (a particle array through
    splat_particles, velocity and normals). On the CPU (`full_size` False)
    the frames are 160x96 (crop (8, 24, 64, 112)) and the 640x360 cases
    192x108."""
    rng = np.random.default_rng(sum(map(ord, case)))
    big = (1920, 1080) if full_size else (160, 96)
    small = (640, 360) if full_size else (192, 108)
    k = dict(crop=None, R=6, radius=1.0, velocity=False, normals=False, slabs=1)
    if case == "tie":
        return dict(k, cells=torch.from_numpy(tie_cells()).to(device),
                    cam=Camera(width=128, height=128, fov_y_deg=90.0), R=3, velocity=True,
                    normals=True)
    w, h = small if case in ("r6_360", "r8_360", "velocity", "lit", "sharded", "particles") \
        else big
    cam = Camera(width=w, height=h)
    if case == "particles":
        view = default_view((16, 16, 16))
        n = 40_000 if full_size else 3_000
        pos = rng.uniform(-2.0, 18.0, (3, n)).astype(np.float32)
        return dict(k, cam=cam, view=view, pos=torch.from_numpy(pos).to(device),
                    vel=torch.from_numpy(rng.uniform(0, 30, n).astype(np.float32)).to(device),
                    velocity=True, normals=True)
    crop = None
    if case == "crop":
        crop = (88, 483, 992, 1024) if full_size else (8, 24, 64, 112)
    y0, x0, ch, cw = crop if crop is not None else (0, 0, h, w)
    m = ch * cw // 3
    if case == "empty":
        cells = _cells(rng, x0 + cw + 50, y0, cw, ch, 500, 20.0, 60.0)  # right of the buffer
    elif case == "near":
        cells = np.concatenate([_cells(rng, x0 + cw // 4, y0 + ch // 4, cw // 8, ch // 8,
                                       m // 20, 2.0, 3.0),
                                _cells(rng, x0, y0, cw, ch, m // 4, 60.0, 900.0)], axis=1)
    else:
        # a blob that leaves the buffer's corners empty, so whole tiles are skipped
        cells = _cells(rng, x0 + cw // 6, y0 + ch // 6, 2 * cw // 3, 2 * ch // 3, m, 20.0, 90.0)
    return dict(k, cells=torch.from_numpy(cells).to(device), cam=cam, crop=crop,
                R=8 if case == "r8_360" else 6,
                velocity=case in ("velocity", "lit", "sharded"),
                normals=case in ("lit", "sharded"), slabs=2 if case == "sharded" else 1)


def splat_pass(k: dict, zbuffer, key_fn, buffers):
    """The case's splat buffers through the given z-buffer, key and
    buffers_from_zbuffer functions: each slab's z-buffer and key (its share
    of the points, a column slice whose rows lie M floats apart, as a slab's
    own splats are), composited with torch.minimum, then the dilation.
    Returns (the composite z-buffer, its key or None, the SplatBuffers)."""
    parts = torch.chunk(k["cells"], k["slabs"], dim=1)
    d = key = None
    for p in parts:
        pd = zbuffer(p, k["cam"], k["crop"])
        d = pd if d is None else torch.minimum(d, pd)
        if k["velocity"]:
            pk = key_fn(p, k["cam"], k["crop"])
            key = pk if key is None else torch.minimum(key, pk)
    return d, key, buffers(d, k["cam"], k["radius"], k["R"], key=key,
                           with_normals=k["normals"])
