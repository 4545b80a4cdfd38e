"""The least time an NVIDIA H100 could take for each kernel's work: the
largest of the bytes the function must move over the card's memory rate,
the float32 operations it must do over the card's rate outside the tensor
cores (NVIDIA's data sheet, SXM part: 3.35 TB/s, 67 TFLOP/s; both assume
the full 700 W power limit) and, where it takes exponentials or square
roots, those over the special-function units' rate: 132 SMs x 16 a clock
x 1.98 GHz (the SXM part's largest SM clock) = 4.18e12 a second.

Both count what the function needs on the inputs of the call that is
timed, not what the kernel does. Bytes: the mass of every slot (it says
which slots are occupied), the other inputs of the occupied slots only
(an empty slot's output is fixed), each read once, and every output
written once, whatever the kernel reads again from the caches. Operations
are counted from the code per occupied slot (or live pixel), with each
slot's axis and tap weights counted once however many passes use them: a
multiply, an add, a compare-and-select, a divide, a square root or an
exponential each count one.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def bound_ms(nbytes: float, flops: float, sfu_ops: float = 0) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which bounds it); the
    operations' time is the larger of the float32 operations' and the
    special-function operations' (`sfu_ops`, counted among `flops` too)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _slot_bytes(n_slots: int, *ts: torch.Tensor) -> int:
    """Bytes of `n_slots` slots of the [..., K, C] tensors `ts`."""
    return sum(n_slots * t.numel() // (t.shape[-2] * t.shape[-1]) * t.element_size()
               for t in ts)


def _occupied(state) -> int:
    return int((state.mass > 0).sum())


def _occupied_cells(state) -> int:
    return int((state.mass > 0).any(dim=0).sum())


# Operations per occupied slot, from the kernels' code, for D axes and
# T = 3^D taps:
def _weight_ops(dim: int) -> int:
    """The offsets from the cell (D), the axis weights (8 an axis), the tap
    offsets (3 an axis) and the T tap weights (D - 1 each): once a slot."""
    return 12 * dim + 3**dim * (dim - 1)


def _p2g1_ops(dim: int) -> int:
    """Pass 1: 2D^2 + 2D + 2 a tap."""
    return 3**dim * (2 * dim * dim + 2 * dim + 2)


def _coef_ops(dim: int) -> int:
    """The density gather (2 a tap), the EOS and force coefficients (15)."""
    return 3**dim * 2 + 15


def _p2g2_ops(dim: int, legacy_strain: bool) -> int:
    """Pass 2: 4D^2 + 4D a tap, or with the legacy strain 2D^2 + 4D a tap
    and D^2 + D to build it."""
    if legacy_strain:
        return (2 * dim * dim + 4 * dim) * 3**dim + dim * dim + dim
    return (4 * dim * dim + 4 * dim) * 3**dim


def _p2g_ops(dim: int, legacy_strain: bool) -> int:
    return _p2g1_ops(dim) + _coef_ops(dim) + _p2g2_ops(dim, legacy_strain)


def _encode_ops(dim: int) -> int:
    """A fixed-point grid: each slot's tap contributions encoded (a
    multiply and a truncation each), D + 1 in pass 1 and D in pass 2."""
    return 3**dim * (2 * dim + 1) * 2


def _g2p_ops(dim: int, n_inter: int) -> int:
    """The gather (2D^2 + 2D a tap), C = 4B, advect, clamp, wall springs
    and the CFL clamp (D^2 + 17D), each interaction (4D + 8)."""
    return 3**dim * (2 * dim * dim + 2 * dim) + dim * dim + 17 * dim + n_inter * (4 * dim + 8)


def _migrate_ops(dim: int) -> int:
    """Each axis phase: floor, subtract and clamp of the axis delta, in the
    reject and again in the select (8)."""
    return 8 * dim


SPLAT_OPS = 30  # a slot's view transform (18), projection and depth test


def p2g_update_work(state, config) -> tuple[int, int]:
    """(bytes, operations) of kernel P: mass, and pos, vel and C of the
    occupied slots in; grid velocity and mass out. The grid update counts
    4D operations a cell that holds a slot."""
    n, c, d = _occupied(state), config.num_cells, config.dim
    nbytes = _nbytes(state.mass) + _slot_bytes(n, state.pos, state.vel, state.C) \
        + 4 * c * (d + 1)
    ops = n * (_weight_ops(d) + _p2g_ops(d, config.legacy_strain)) \
        + _occupied_cells(state) * 4 * d
    if config.fixed_point:  # int32 grid, 4 B a value as float32; the codings
        # add the encodes, a decode of each cell's mass and momentum for
        # the update and of its mass for the density, and the re-encode
        ops += n * _encode_ops(d) + _occupied_cells(state) * (3 * d + 2)
    return nbytes, ops


def g2p_migrate_work(state, config, n_inter: int = 0, emit: bool = False) -> tuple[int, int]:
    """(bytes, operations) of kernel F: mass, and pos and ids of the
    occupied slots and the grid velocity of their cells in (the input vel
    and C are not read); the state out, and with `emit` the [5, C] splats."""
    n, c, d = _occupied(state), config.num_cells, config.dim
    nbytes = (_nbytes(state.mass) + _slot_bytes(n, state.pos, state.ids)
              + 4 * d * _occupied_cells(state)
              + _nbytes(state.pos, state.vel, state.C, state.mass, state.ids)
              + (20 * c if emit else 0))
    ops = _weight_ops(d) + _g2p_ops(d, n_inter) + _migrate_ops(d) + (SPLAT_OPS if emit else 0)
    # a fixed-point grid velocity (int32, 4 B as float32): one decode a
    # component of each occupied cell
    return nbytes, n * ops + (d * _occupied_cells(state) if config.fixed_point else 0)


def blur_work(fsize_x: torch.Tensor, fsize_y: torch.Tensor) -> tuple[int, int, int]:
    """(bytes, operations, exponentials) of kernel BL on an [H, W] depth
    buffer, from the filter size of each live pixel in the X pass and the Y
    pass (0 where the pixel passes through): the buffer in and out once; a
    live pixel's filter size costs 10, each of its 2 fsize taps 9 (one of
    them its exponential) and the quotient 1."""
    nbytes = 2 * 4 * fsize_x.numel()
    ops = exps = 0
    for f in (fsize_x, fsize_y):
        live, taps = int((f > 0).sum()), 2 * int(f.sum())
        ops += 11 * live + 9 * taps
        exps += taps
    return nbytes, ops, exps


# A live pixel of kernel SH (csrc/ssfr_shade.cu), counted from the code:
# the normal from five view positions (95), the specular (20), the Fresnel
# (6), the reflection and its rotation (15), the sky (38), the refraction's
# sample (27), Beer's law and the composite (22), the live test (2). Of
# them 7 special-function operations: the two powers (a logarithm and an
# exponential each) and the three exponentials.
SHADE_OPS = 225
SHADE_SFU = 7


def shade_work(live: torch.Tensor, bg_color: torch.Tensor,
               thickness: bool = False) -> tuple[int, int, int]:
    """(bytes, operations, special-function operations) of kernel SH from
    its live mask [h, w] and the frame's background colour [H, W, 3]: the
    frame's colour in once (a pixel's own, or a live pixel's refracted
    sample) and out once; each buffer pixel's depth and background depth in
    and its live byte out, and the thickness map in when there is one."""
    n_live = int(live.sum())
    nbytes = 2 * _nbytes(bg_color) + live.numel() * (4 + 4 + 1 + (4 if thickness else 0))
    return nbytes, n_live * SHADE_OPS, n_live * SHADE_SFU


def zbuffer_work(cells: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(bytes, operations) of the splat kernel's z-buffer: each point's
    pixel x, pixel y and depth in, the [h, w] buffer out once; a point's
    floors, conversions, offsets, on-buffer tests and index (10)."""
    m = cells.shape[1]
    return 12 * m + 4 * h * w, 10 * m


# The splat kernel's dilation (csrc/splat_dilate.cu), counted from the
# code: a pixel's Q (a division, a square, a max) and its start (a compare,
# a subtract); every tap's r^2 - Q c and its test (a multiply, a subtract, a
# compare); a tap inside an occupied source's disc, its offer (a square
# root, on the special-function units, and a subtract) and the min.
DILATE_PIXEL_OPS = 5
DILATE_TAP_OPS = 3
DILATE_DISC_OPS = 3


def dilate_work(depth: torch.Tensor, cam, sphere_radius: float,
                max_radius_px: int) -> tuple[int, int, int]:
    """(bytes, operations, square roots) of the default mode's dilation of
    an [h, w] depth buffer at splat radius R: the buffer in and out once;
    every pixel's (2R+1)^2 - 1 taps; the offers, the taps whose source is
    occupied (depth < BG_DEPTH) and inside the image with r^2 - Q c >= 0 in
    float32, one square root each."""
    from ..render.splat import BG_DEPTH
    from ..render.splat_kernel import dilate_constants

    h, w = depth.shape
    R = max_radius_px
    focal, _, r2, q_clamp, _ = dilate_constants(cam, sphere_radius, R)
    ys, xs = torch.nonzero(depth < BG_DEPTH, as_tuple=True)
    z = depth[ys, xs] / torch.tensor(focal, dtype=torch.float32, device=depth.device)
    q = torch.clamp_min(z * z, q_clamp)
    roots = 0
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            if dx or dy:
                roots += int(((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
                              & (r2 - q * float(dx * dx + dy * dy) >= 0.0)).sum())
    taps = h * w * ((2 * R + 1) ** 2 - 1)
    ops = h * w * DILATE_PIXEL_OPS + taps * DILATE_TAP_OPS + roots * DILATE_DISC_OPS
    return 2 * 4 * h * w, ops, roots


def sim2d_work(state, config, n_inter: int = 0) -> tuple[int, int]:
    """(bytes, operations) of sim2d: mass, and pos, vel and C of the
    occupied slots in (32 B a slot in float32); pos, vel and C out. The
    slot weights serve P2G and G2P alike, so they count once."""
    n = _occupied(state)
    nbytes = (_nbytes(state.mass) + _slot_bytes(n, state.pos, state.vel, state.C)
              + _nbytes(state.pos, state.vel, state.C))
    ops = n * (_weight_ops(2) + _p2g_ops(2, config.legacy_strain) + _g2p_ops(2, n_inter)) \
        + _occupied_cells(state) * 8
    return nbytes, ops


def migrate_work(state, config) -> tuple[int, int]:
    """(bytes, operations) of migrate2d and of kernel E: mass, and pos,
    vel, C and ids of the occupied slots in (36 B a slot in 2D float32, 64 B
    in 3D); the state out."""
    n = _occupied(state)
    nbytes = (_nbytes(state.mass) + _slot_bytes(n, state.pos, state.vel, state.C, state.ids)
              + _nbytes(state.pos, state.vel, state.C, state.mass, state.ids))
    return nbytes, n * _migrate_ops(config.dim)


def _slab_grid_cells(config) -> int:
    """Cells of a slab's grid: one plane more than the slab on each side."""
    return config.num_cells // config.grid_res[0] * (config.grid_res[0] + 2)


def p2g1_shard_work(padded, config) -> tuple[int, int]:
    """(bytes, operations) of the sharded stage 1 on a padded slab under its
    slab config: mass, and pos, vel and C of the occupied slots in; the
    grid mass and pass-1 momentum of the slab's grid out."""
    n, d = _occupied(padded), config.dim
    nbytes = (_nbytes(padded.mass) + _slot_bytes(n, padded.pos, padded.vel, padded.C)
              + 4 * _slab_grid_cells(config) * (d + 1))
    ops = n * (_weight_ops(d) + _p2g1_ops(d))
    if config.fixed_point:  # pass 1's encodes (D + 1 a tap)
        ops += n * 3**d * (d + 1) * 2
    return nbytes, ops


def p2g2u_shard_work(padded, config) -> tuple[int, int]:
    """(bytes, operations) of the sharded stage 2: mass, and pos and C of
    the occupied slots, the grid mass of every grid cell and the pass-1
    momentum of the occupied cells in; the grid velocity out. The update
    counts 4D operations a cell that holds a slot."""
    n, d, cells = _occupied(padded), padded.dim, _occupied_cells(padded)
    gc = _slab_grid_cells(config)
    nbytes = (_nbytes(padded.mass) + _slot_bytes(n, padded.pos, padded.C) + 4 * gc
              + 4 * d * cells + 4 * d * gc)
    ops = n * (_weight_ops(d) + _coef_ops(d) + _p2g2_ops(d, config.legacy_strain)) + cells * 4 * d
    if config.fixed_point:  # pass 2's encodes, the decodes and the re-encode
        ops += n * 3**d * d * 2 + cells * (3 * d + 2)
    return nbytes, ops
