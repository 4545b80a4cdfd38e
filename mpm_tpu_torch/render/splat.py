"""Particle splatting as sphere impostors (port of ``mpm_tpu.render.splat``,
the bucket-state path).

Splat points [5, M] (pixel x, pixel y, linear depth, |vel|, count) come from
kernel X or kernel F's emission (one per cell), or from every live slot
(`extract_slot_splats`, quality "particle"). `zbuffer_cells` keeps the
nearest depth of each centre pixel with a scatter-min, which is exact in any
order; `_dilate_spheres` grows each point into a disc with the analytic
sphere depth d(dx, dy) = z - sqrt(r^2 - c * Q), a min over shifted windows.
The velocity key, the thickness deposit and the lit-sphere normals wait with
their render modes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .camera import Camera, view_to_screen, world_to_view
from .extract_kernel import CELL_BG

BG_DEPTH = 4000.0  # "no fluid here" sentinel, past the blur guard 3990


class SplatBuffers(NamedTuple):
    """The splat pass's image buffers; the depth-only modes need only the
    depth (the velocity and normal buffers come with their modes)."""

    depth: torch.Tensor  # [H, W] linear view depth (BG_DEPTH where empty)


def _slot_rows(pos, vel, mass, view, cam: Camera) -> torch.Tensor:
    """Bucket fields ([3, ...], [3, ...], [...]) -> [5, M] slot-splat rows
    (pixel x, pixel y, linear depth, |vel|, live). Shared by the full and
    the surface-band extractions so their rows are op-identical."""
    pos = pos.reshape(3, -1)
    vel = vel.reshape(3, -1).float()
    occ = mass.reshape(-1) > 0
    px, py, depth = view_to_screen(world_to_view(pos, view), cam)
    vmag = torch.sqrt(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2)
    valid = occ & (depth > cam.near)
    return torch.stack([px, py, torch.where(valid, depth, CELL_BG), vmag,
                        valid.float()])


def extract_slot_splats(state, view, cam: Camera) -> torch.Tensor:
    """[5, K*C] rows of every slot of a BucketState (quality "particle");
    empty and behind-camera slots get depth CELL_BG."""
    return _slot_rows(state.pos, state.vel, state.mass, view, cam)


def _band_slices(grid_res, bands):
    """The six (x, y, z) cell-space slices of the surface-band keep set, or
    None when the bands cover (nearly) the whole grid: bf bottom and bt top
    y planes, and bs-thick x and z wall faces of the middle. Disjoint."""
    nx, ny, nz = grid_res
    bt, bf, bs = bands
    if bf + bt >= ny or 2 * bs >= min(nx, nz):
        return None
    ymid = slice(bf, ny - bt)
    return [
        (slice(None), slice(0, bf), slice(None)),
        (slice(None), slice(ny - bt, ny), slice(None)),
        (slice(0, bs), ymid, slice(None)),
        (slice(nx - bs, nx), ymid, slice(None)),
        (slice(bs, nx - bs), ymid, slice(0, bs)),
        (slice(bs, nx - bs), ymid, slice(nz - bs, nz)),
    ]


def extract_band_slot_splats(state, view, cam: Camera, grid_res, bands) -> torch.Tensor:
    """[5, M] slot rows of the grid's shell only: `bands` = (top, bottom,
    side) cell-plane thicknesses. An interior slot never wins the min-depth
    z-buffer of a band-shaped fluid (a pool), so only the shell is splatted;
    `surface_band_uncovered` certifies the keep set for a state."""
    sl = _band_slices(grid_res, bands)
    if sl is None:
        return extract_slot_splats(state, view, cam)
    nx, ny, nz = grid_res
    k = state.mass.shape[0]

    def shell(a, lead):
        a = a.reshape(*lead, k, nx, ny, nz)
        return torch.cat([a[..., xs, ys, zs].reshape(*lead, k, -1) for xs, ys, zs in sl],
                         dim=-1)

    return _slot_rows(shell(state.pos, (3,)), shell(state.vel, (3,)),
                      shell(state.mass, ()), view, cam)


def _surface_cells(state, grid_res, reach: int) -> torch.Tensor:
    """[nx, ny, nz] bool: live cells within `reach` cells of air
    (6-neighbourhood; the array edges count as air)."""
    nx, ny, nz = grid_res
    live = (state.mass > 0).any(dim=0).reshape(nx, ny, nz)
    near = ~live
    for _ in range(reach):
        p = F.pad(near[None, None].float(), (1, 1, 1, 1, 1, 1), value=1.0)[0, 0] > 0
        near = (near
                | p[:-2, 1:-1, 1:-1] | p[2:, 1:-1, 1:-1]
                | p[1:-1, :-2, 1:-1] | p[1:-1, 2:, 1:-1]
                | p[1:-1, 1:-1, :-2] | p[1:-1, 1:-1, 2:])
    return live & near


def _cell_index(grid_res, device):
    nx, ny, nz = grid_res
    return torch.meshgrid(torch.arange(nx, device=device), torch.arange(ny, device=device),
                          torch.arange(nz, device=device), indexing="ij")


def surface_band_uncovered(state, grid_res, bands, reach: int = 2) -> int:
    """Certificate of extract_band_slot_splats: the count of live cells
    within `reach` cells of air that the bands do not cover. 0 certifies
    that only interior slots were culled. A diagnostic: run it outside
    timed windows."""
    nx, ny, nz = grid_res
    surface = _surface_cells(state, grid_res, reach)
    bt, bf, bs = bands
    ix, iy, iz = _cell_index(grid_res, surface.device)
    in_band = ((iy < bf) | (iy >= ny - bt) | (ix < bs) | (ix >= nx - bs)
               | (iz < bs) | (iz >= nz - bs))
    return int((surface & ~in_band).sum())


def surface_band_min_top(state, grid_res, bf: int, bs: int, reach: int = 2) -> int:
    """The least top-band thickness bt with surface_band_uncovered(state,
    grid_res, (bt, bf, bs), reach) == 0: ny minus the lowest y of a surface
    cell that the bottom and side bands do not cover (0 if none)."""
    nx, ny, nz = grid_res
    surface = _surface_cells(state, grid_res, reach)
    ix, iy, iz = _cell_index(grid_res, surface.device)
    mid = (surface & (iy >= bf) & (ix >= bs) & (ix < nx - bs)
           & (iz >= bs) & (iz < nz - bs))
    return ny - int(torch.where(mid, iy, ny).min())


def fit_surface_bands(state, grid_res, reach: int = 2, margin: int = 2):
    """Surface bands (top, bottom, side) for a settled pool, as the JAX
    package's bench.py fits them: the position clamps pin the floor and the
    walls, so the bottom and side bands are reach + 3 planes; the top band
    is the least one whose certificate reads 0, plus `margin` planes for the
    sloshing to come. None when no band fits (render every slot)."""
    bf = bs = reach + 3
    bt = margin + surface_band_min_top(state, grid_res, bf, bs, reach)
    return None if bt + bf >= grid_res[1] else (bt, bf, bs)


def zbuffer_cells(cells: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """The pre-dilation z-buffer: the scatter-min depth [H, W] of the splat
    points' centre pixels, BG_DEPTH where empty. With `crop` = (y0, x0, ch,
    cw) the buffer is the crop rectangle and splats outside it are dropped,
    so the crop must be conservative (camera.crop_for_aabb)."""
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    px, py, depth = cells[0], cells[1], cells[2]
    ix = torch.floor(px).to(torch.int64) - x0
    iy = torch.floor(py).to(torch.int64) - y0
    on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & (depth < CELL_BG)
    pix = torch.where(on, iy * w + ix, h * w)  # offscreen -> guard slot
    d = torch.full((h * w + 1,), BG_DEPTH, dtype=depth.dtype, device=depth.device)
    d.scatter_reduce_(0, pix, torch.where(on, depth, BG_DEPTH), reduce="amin")
    return d[:h * w].reshape(h, w)


def _dilate_spheres(bufs: SplatBuffers, cam: Camera, sphere_radius: float,
                    max_radius_px: int) -> SplatBuffers:
    """Expand point deposits into sphere-impostor discs with analytic depth.

    Per tap (dx, dy) of the (2R+1)^2 - 1 neighbours, with c = dx^2 + dy^2,
    a source of depth z offers z - sqrt(r^2 - c * Q), Q = max((z/f)^2,
    (r/R)^2) (infinite for an empty source), where r^2 - c * Q >= 0; the
    pixel keeps the least offer. The taps of one row dy run together on a
    strided view [h, 2R+1, w] of the padded buffers (7 operations a row,
    not a few per tap: eager PyTorch is bound by its launches here). The
    square root of a negative is NaN and counts as no offer; the centre
    tap gets c = inf, so it never offers. A min is exact in any order, so
    this is bit for bit the JAX package's masked loop. The shape comes from
    the buffers, so a crop dilates its rectangle only."""
    h, w = bufs.depth.shape
    dev = bufs.depth.device
    R = max_radius_px
    f = torch.tensor(cam.focal_px, dtype=torch.float32, device=dev)
    pad = max(R, 1)
    d0 = F.pad(bufs.depth, (pad, pad, pad, pad), value=BG_DEPTH)
    r2 = sphere_radius * sphere_radius
    q_clamp = r2 / float(R * R) if R else 1.0
    q = torch.clamp_min((bufs.depth / f) ** 2, q_clamp)
    q = torch.where(bufs.depth < BG_DEPTH, q, torch.inf)
    q0 = F.pad(q, (pad, pad, pad, pad), value=torch.inf)

    center = bufs.depth < BG_DEPTH  # a centre pixel shows its sphere's pole
    best = torch.where(center, bufs.depth - sphere_radius, bufs.depth)
    # window j of a row reads column x + j - pad: dx = pad - j
    dxs = torch.arange(pad + R, pad - R - 1, -1, dtype=torch.float32, device=dev) - pad
    taps = slice(pad - R, pad + R + 1)
    for dy in range(-R, R + 1):
        c = dxs * dxs + float(dy * dy)
        if dy == 0:
            c[R] = torch.inf  # the centre tap (dx = 0)
        src_d = d0[pad - dy:pad - dy + h].unfold(1, w, 1)[:, taps]
        src_q = q0[pad - dy:pad - dy + h].unfold(1, w, 1)[:, taps]
        cand = src_d - torch.sqrt(r2 - src_q * c[:, None])
        cand = torch.nan_to_num(cand, nan=torch.inf, posinf=torch.inf)
        best = torch.fmin(best, cand.amin(dim=1))
    return SplatBuffers(depth=best)


def buffers_from_zbuffer(d: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                         max_radius_px: int = 6) -> SplatBuffers:
    """The sphere-impostor dilation of a raw z-buffer (the second half of
    splat_cells)."""
    bufs = SplatBuffers(depth=torch.where(d < BG_DEPTH, d, BG_DEPTH))
    return _dilate_spheres(bufs, cam, sphere_radius, max_radius_px)


def splat_cells(cells: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                max_radius_px: int = 6, crop=None) -> SplatBuffers:
    """z-buffer plus sphere dilation over splat points [5, M]."""
    return buffers_from_zbuffer(zbuffer_cells(cells, cam, crop=crop), cam,
                                sphere_radius, max_radius_px)
