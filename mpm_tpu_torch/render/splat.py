"""Particle splatting as sphere impostors (port of ``mpm_tpu.render.splat``).

Splat points [5, M] (pixel x, pixel y, linear depth, |vel|, count) come from
kernel X or kernel F's emission (one per cell), or from every live slot
(`extract_slot_splats`, quality "particle"). `zbuffer_cells` keeps the
nearest depth of each centre pixel with a scatter-min, which is exact in any
order, and `velocity_key` the packed (depth bits | quantised |vel|) key that
attributes a velocity to it; `_dilate_spheres` grows each point into a disc
with the analytic sphere depth d(dx, dy) = z - sqrt(r^2 - c * Q), a min over
shifted windows, carrying the winner's velocity and sphere-local offsets for
the velocity and lit-sphere modes. `thickness_deposit` adds each cell's
material at its centre pixel, in the same bits on every call.
`splat_particles` z-buffers a particle array by sorting (the
`--sphere-render-ratio` path).

On a CUDA device the z-buffer, the key and the dilation run as the splat
kernels (render/splat_kernel.py, csrc/splat_dilate.cu), bit for bit these
plain versions (`zbuffer_cells_plain`, `velocity_key_plain`,
`buffers_from_zbuffer_plain`, `_dilate_spheres`), which run on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fmath import sqrt_rn
from ..utils.timing import spanned
from . import splat_kernel
from .camera import Camera, view_to_screen, world_to_view
from .extract_kernel import CELL_BG

BG_DEPTH = 4000.0  # "no fluid here" sentinel, past the blur guard 3990
KEY_EMPTY = 0x7F7FFFFF  # velocity key of a pixel no splat reaches
thickness_deposits = 0  # calls of thickness_deposit, on every device (a replay counts as one)


class SplatBuffers(NamedTuple):
    """The splat pass's image buffers. The depth-only chains leave the
    velocity None; sx and sy are the covering sphere's local offsets, set
    for the lit-sphere mode only: normal = (sx, -sy, sqrt(1 - sx^2 - sy^2))."""

    depth: torch.Tensor  # [H, W] linear view depth (BG_DEPTH where empty)
    velocity: torch.Tensor | None = None  # [H, W] |vel| of the winner (0 where empty)
    sx: torch.Tensor | None = None
    sy: torch.Tensor | None = None


def _slot_rows(pos, vel, mass, view, cam: Camera) -> torch.Tensor:
    """Bucket fields ([3, ...], [3, ...], [...]) -> [5, M] slot-splat rows
    (pixel x, pixel y, linear depth, |vel|, live). Shared by the full and
    the surface-band extractions so their rows are op-identical."""
    pos = pos.reshape(3, -1)
    vel = vel.reshape(3, -1).float()
    occ = mass.reshape(-1) > 0
    px, py, depth = view_to_screen(world_to_view(pos, view), cam)
    vmag = sqrt_rn(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2)
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


def _pixels(cells: torch.Tensor, cam: Camera, crop):
    """(pixel index [M], on-screen mask [M], h, w) of the splat points'
    centre pixels in the frame or the crop (y0, x0, ch, cw); offscreen and
    empty points get the guard index h * w."""
    y0, x0, h, w = crop if crop is not None else (0, 0, cam.height, cam.width)
    ix = torch.floor(cells[0]).to(torch.int64) - x0
    iy = torch.floor(cells[1]).to(torch.int64) - y0
    on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & (cells[2] < CELL_BG)
    return torch.where(on, iy * w + ix, h * w), on, h, w


def zbuffer_cells(cells: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """The pre-dilation z-buffer: the scatter-min depth [H, W] of the splat
    points' centre pixels, BG_DEPTH where empty. With `crop` = (y0, x0, ch,
    cw) the buffer is the crop rectangle and splats outside it are dropped,
    so the crop must be conservative (camera.crop_for_aabb). The plain
    version on the CPU, the splat kernel's z-buffer on a card."""
    if cells.device.type == "cpu":
        return zbuffer_cells_plain(cells, cam, crop)
    return splat_kernel.zbuffer(cells, cam, crop)


def zbuffer_cells_plain(cells: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """zbuffer_cells as a scatter_reduce_ amin."""
    pix, on, h, w = _pixels(cells, cam, crop)
    depth = cells[2]
    d = torch.full((h * w + 1,), BG_DEPTH, dtype=depth.dtype, device=depth.device)
    d.scatter_reduce_(0, pix, torch.where(on, depth, BG_DEPTH), reduce="amin")
    return d[:h * w].reshape(h, w)


def velocity_key(cells: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """The velocity attribution key [H, W] int32: a scatter-min of (float
    bits of the depth & ~0xFFF) | clip(|vel| * 64, 0, 4095). The bits of a
    positive float order as its value, so the nearest splat's key wins (to
    2^-11 of the depth); KEY_EMPTY where no splat lands. Exact in any order,
    so slabs composite it with a min. The plain version on the CPU, the
    splat kernel's key on a card."""
    if cells.device.type == "cpu":
        return velocity_key_plain(cells, cam, crop)
    return splat_kernel.zbuffer(cells, cam, crop, key=True)


def velocity_key_plain(cells: torch.Tensor, cam: Camera, crop=None) -> torch.Tensor:
    """velocity_key as a scatter_reduce_ amin."""
    pix, on, h, w = _pixels(cells, cam, crop)
    dbits = torch.clamp_min(cells[2], 1e-6).view(torch.int32) & ~0xFFF
    qvel = torch.clamp(cells[3] * 64.0, 0.0, 4095.0).to(torch.int32)
    key = torch.where(on, dbits | qvel, KEY_EMPTY)
    k = torch.full((h * w + 1,), KEY_EMPTY, dtype=torch.int32, device=cells.device)
    k.scatter_reduce_(0, pix, key, reduce="amin")
    return k[:h * w].reshape(h, w)


def _windows(a: torch.Tensor, dy: int, pad: int, R: int, h: int, w: int) -> torch.Tensor:
    """[h, 2R+1, w] view of padded `a`: window i of row dy reads the source
    at (y - dy, x - dx) with dx = R - i."""
    return a[pad - dy:pad - dy + h].unfold(1, w, 1)[:, pad - R:pad + R + 1]


@spanned("mpm.render.dilate")
def _dilate_spheres(bufs: SplatBuffers, cam: Camera, sphere_radius: float,
                    max_radius_px: int, with_velocity: bool = False,
                    with_normals: bool = False) -> SplatBuffers:
    """Expand point deposits into sphere-impostor discs with analytic depth.

    Per tap (dx, dy) of the (2R+1)^2 - 1 neighbours, with c = dx^2 + dy^2,
    a source of depth z offers z - sqrt(r^2 - c * Q), Q = max((z/f)^2,
    (r/R)^2) (infinite for an empty source), where r^2 - c * Q >= 0; the
    pixel keeps the least offer. The taps of one row dy run together on a
    strided view [h, 2R+1, w] of the padded buffers (7 operations a row,
    not a few per tap: eager PyTorch is bound by its launches here). The
    square root of a negative is NaN and counts as no offer; the centre
    tap gets c = inf, so it never offers. A min is exact in any order, so
    the depth is bit for bit the JAX package's masked loop.

    With `with_velocity` / `with_normals` the pixel also keeps the winning
    source's velocity / its sphere-local offsets (dx, dy) * sqrt(Q) / r. The
    JAX loop walks dy, then dx, ascending and takes an offer only below the
    best so far, so of equal offers the first tap in that order wins: here
    the row's least offer replaces the best only when it is smaller, and of
    the row's equal least offers the one of least dx (the last window)
    gives the attributes. The shape comes from the buffers, so a crop
    dilates its rectangle only."""
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
    track = with_velocity or with_normals
    best_v = best_sx = best_sy = None
    if with_velocity:
        best_v = bufs.velocity
        v0 = F.pad(best_v, (pad, pad, pad, pad))
    if with_normals:
        best_sx = best_sy = torch.zeros_like(best)
        sq0 = sqrt_rn(q0) * (1.0 / sphere_radius)  # s = sqrt(c) * sqrt(Q) / r
    win = torch.arange(2 * R + 1, device=dev)[None, :, None]
    # window i of a row reads column x + i - R: dx = R - i
    dxs = torch.arange(R, -R - 1, -1, dtype=torch.float32, device=dev)
    for dy in range(-R, R + 1):
        c = dxs * dxs + float(dy * dy)
        if dy == 0:
            c[R] = torch.inf  # the centre tap (dx = 0)
        cand = _windows(d0, dy, pad, R, h, w) - sqrt_rn(
            r2 - _windows(q0, dy, pad, R, h, w) * c[:, None])
        cand = torch.nan_to_num(cand, nan=torch.inf, posinf=torch.inf)
        if not track:
            best = torch.fmin(best, cand.amin(dim=1))
            continue
        m = cand.amin(dim=1)
        i = torch.where(cand == m[:, None], win, -1).amax(dim=1, keepdim=True)
        take = m < best
        best = torch.where(take, m, best)
        if with_velocity:
            best_v = torch.where(take, _windows(v0, dy, pad, R, h, w).gather(1, i)[:, 0], best_v)
        if with_normals:
            sq = _windows(sq0, dy, pad, R, h, w).gather(1, i)[:, 0]
            best_sx = torch.where(take, (R - i[:, 0]).float() * sq, best_sx)
            best_sy = torch.where(take, float(dy) * sq, best_sy)
    return SplatBuffers(depth=best, velocity=best_v, sx=best_sx, sy=best_sy)


@spanned("mpm.render.dilate")
def _dilate_kernel(depth: torch.Tensor, cam: Camera, sphere_radius: float, max_radius_px: int,
                   velocity=None, key=None, raw: bool = False, with_velocity: bool = False,
                   with_normals: bool = False) -> SplatBuffers:
    """_dilate_spheres (after buffers_from_zbuffer_plain's decode, with
    `raw`) as one launch of the splat kernel."""
    return SplatBuffers(*splat_kernel.dilate(depth, cam, sphere_radius, max_radius_px, velocity,
                                             key, raw, with_velocity, with_normals))


def buffers_from_zbuffer(d: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                         max_radius_px: int = 6, key: torch.Tensor | None = None,
                         with_normals: bool = False) -> SplatBuffers:
    """The second half of splat_cells: decode the velocity key (when given;
    the velocity is then tracked through the dilation) and dilate the raw
    z-buffer into sphere impostors. The plain version on the CPU, one launch
    of the splat kernel's dilation on a card."""
    if d.device.type == "cpu":
        return buffers_from_zbuffer_plain(d, cam, sphere_radius, max_radius_px, key,
                                          with_normals)
    return _dilate_kernel(d, cam, sphere_radius, max_radius_px, key=key, raw=True,
                          with_velocity=key is not None, with_normals=with_normals)


def buffers_from_zbuffer_plain(d: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                               max_radius_px: int = 6, key: torch.Tensor | None = None,
                               with_normals: bool = False) -> SplatBuffers:
    """buffers_from_zbuffer in plain PyTorch: the decode, then
    _dilate_spheres."""
    occ = d < BG_DEPTH
    vel = None
    if key is not None:
        vel = torch.where(occ, (key & 0xFFF).to(d.dtype) * (1.0 / 64.0), 0.0)
    bufs = SplatBuffers(depth=torch.where(occ, d, BG_DEPTH), velocity=vel)
    return _dilate_spheres(bufs, cam, sphere_radius, max_radius_px,
                           with_velocity=key is not None, with_normals=with_normals)


@spanned("mpm.render.splat")
def splat_cells(cells: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                max_radius_px: int = 6, crop=None, with_velocity: bool = False,
                with_normals: bool = False) -> SplatBuffers:
    """z-buffer plus sphere dilation over splat points [5, M]; with
    `with_velocity` the velocity key attributes each pixel's velocity (it
    may pick a splat within 2^-11 of the depth winner's depth)."""
    key = velocity_key(cells, cam, crop) if with_velocity else None
    return buffers_from_zbuffer(zbuffer_cells(cells, cam, crop=crop), cam, sphere_radius,
                                max_radius_px, key=key, with_normals=with_normals)


def _sum_by_pixel(n: int, pix: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[p] = the sum of w over pix == p, [n] float32, the same bits on
    every call: on CUDA the accumulating index_put_ sorts the indices
    stably and adds each index's run in one pass (index_add_ and
    scatter_add_ there use float atomics, whose order changes from run to
    run); on the CPU index_add_ adds in point order. A run is added
    serially, so indices that would share a long run need their own slots."""
    out = torch.zeros(n, dtype=torch.float32, device=w.device)
    if w.device.type == "cpu":
        return out.index_add_(0, pix, w)
    return out.index_put_((pix,), w, accumulate=True)


@spanned("mpm.render.thickness")
def thickness_deposit(cells: torch.Tensor, cam: Camera, sphere_radius: float = 1.0,
                      crop=None) -> torch.Tensor:
    """The additive thickness splat [H, W] (the SSFR pass the reference
    skipped, screen_space_fluid_rendering.gd:429): every splat point adds
    its cell's material, count * 2r, weighted by its projected 1-world-unit
    footprint (f / z)^2, at its centre pixel; occluded cells add too. After
    ssfr.thickness_map's area-preserving blur a pixel reads the material
    column behind it in world units. With `crop` the buffer is the crop
    rectangle. Sums over disjoint point sets add, so slabs composite it
    with a sum. Each point off the frame (or empty) adds its zero to a slot
    of its own past the image, not to one shared guard slot."""
    global thickness_deposits
    thickness_deposits += 1
    pix, on, h, w = _pixels(cells, cam, crop)
    depth, count = cells[2], cells[4]
    m = cells.shape[1]
    own = torch.where(on, pix, h * w + torch.arange(m, device=cells.device))
    # a fill, not an upload: a copy from host memory would wait for the card
    focal = torch.full((), cam.focal_px, dtype=torch.float32, device=cells.device)
    fz = focal / torch.clamp_min(depth, 1e-3)
    weight = torch.where(on, (2.0 * sphere_radius) * count * (fz * fz), 0.0)
    return _sum_by_pixel(h * w + m, own, weight)[:h * w].reshape(h, w)


def _point_deposit(px, py, depth, velocity, cam: Camera, keep) -> SplatBuffers:
    """The nearest particle's depth and velocity at each centre pixel, by
    sorting: a stable depth sort, then a stable pixel sort, leaves each
    pixel's nearest particle first in its segment (found by searchsorted)."""
    h, w = cam.height, cam.width
    ix = torch.floor(px).to(torch.int64)
    iy = torch.floor(py).to(torch.int64)
    on = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & keep
    pix = torch.where(on, iy * w + ix, h * w)  # offscreen -> guard id
    order_d = torch.argsort(depth, stable=True)
    order = order_d[torch.argsort(pix[order_d], stable=True)]
    pix_s = pix[order]
    ids = torch.arange(h * w + 1, dtype=pix_s.dtype, device=pix_s.device)
    seg_start = torch.searchsorted(pix_s, ids[:-1])
    occupied = torch.searchsorted(pix_s, ids[1:]) > seg_start
    idx = torch.clamp(seg_start, 0, depth.shape[0] - 1)
    d = torch.where(occupied, depth[order][idx], BG_DEPTH).reshape(h, w)
    v = torch.where(occupied, velocity[order][idx], 0.0).reshape(h, w)
    return SplatBuffers(depth=d, velocity=v)


def splat_particles(pos: torch.Tensor, vel_mag: torch.Tensor, view, cam: Camera,
                    sphere_radius: float = 1.0, max_radius_px: int = 6,
                    sphere_render_ratio: float = 1.0,
                    with_normals: bool = False) -> SplatBuffers:
    """The splat pass over a particle array, pos [3, N] and |vel| [N]: the
    sorted point deposit, then the dilation with the velocity. A ratio
    below 1 keeps particle i when (i % 100) + 1 <= ratio * 100, the
    reference's LOD slider (depth_map.gdshader:23-26)."""
    px, py, depth = view_to_screen(world_to_view(pos, view), cam)
    keep = depth > cam.near
    if sphere_render_ratio < 1.0:
        idx = torch.arange(pos.shape[-1], device=pos.device)
        keep = keep & (((idx % 100) + 1).float() <= float(np.float32(sphere_render_ratio * 100.0)))
    bufs = _point_deposit(px, py, depth, vel_mag, cam, keep)
    if bufs.depth.device.type == "cpu":
        return _dilate_spheres(bufs, cam, sphere_radius, max_radius_px, with_velocity=True,
                               with_normals=with_normals)
    return _dilate_kernel(bufs.depth, cam, sphere_radius, max_radius_px, velocity=bufs.velocity,
                          with_velocity=True, with_normals=with_normals)
