"""Plain MLS-MPM substep on bucket arrays (3D, float grid, slip walls).

State layout: pos [3, K, C], vel [3, K, C], C [3, 3, K, C], mass [K, C],
ids [K, C] (-1 empty), C = the cells of the (possibly y-windowed) grid,
flat row-major. The invariant is floor(pos) == bucket cell. One substep:

    P2G pass 1 (mass, APIC momentum) -> density, Tait EOS, eq. 16 force
    -> P2G pass 2 -> grid velocity, gravity, slip bands
    -> G2P (vel, C = 4B) -> advect, clamp, wall springs, CFL clamp
    -> migration: z, y, x phases; each cell takes [stay, from-left,
       from-right] in slot order; a move into a full cell (or, on a
       y-window, up out of its top band) is rejected and clamped back.

Every quantity is computed in `cdt` (float32; the control passes
bfloat16) and stored as the configuration states: pos float32, vel and C
in `storage_dtype`. Gathers at constant flat offsets over a zero-padded
cell axis; sums over the slots run in slot order.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F

CFL_EPS = 1e-3
TAPS = tuple(itertools.product((0, 1, 2), repeat=3))


@dataclasses.dataclass(frozen=True)
class Params:
    """The configuration file's numbers: `grid` is the domain (nx, ny, nz)."""

    grid: tuple[int, int, int]
    K: int
    storage: torch.dtype
    eos_power_static: float
    bc_band_lo: int
    bc_band_hi: int
    clamp_lo: float
    clamp_hi_offset: float
    wall_min: float
    wall_max_offset: float
    wall_stiffness: float
    dt: float
    gravity: tuple[float, float, float]
    rest_density: float
    dynamic_viscosity: float
    eos_stiffness: float
    eos_power: float
    pressure_floor: float

    @staticmethod
    def from_config(cfg: dict) -> "Params":
        sim, fl = cfg["sim"], cfg["fluid"]
        if sim["bc"] != "slip" or sim["fixed_point"] or sim["legacy_strain"]:
            raise ValueError("the reference covers slip walls, float grids, the full strain")
        return Params(
            grid=tuple(sim["grid_res"]), K=sim["bin_capacity"],
            storage=torch.bfloat16 if sim["storage_dtype"] == "bfloat16" else torch.float32,
            eos_power_static=float(sim["eos_power_static"]),
            bc_band_lo=sim["bc_band_lo"], bc_band_hi=sim["bc_band_hi"],
            clamp_lo=sim["clamp_lo"], clamp_hi_offset=sim["clamp_hi_offset"],
            wall_min=sim["wall_min"], wall_max_offset=sim["wall_max_offset"],
            wall_stiffness=sim["wall_stiffness"], dt=fl["dt"], gravity=tuple(fl["gravity"]),
            rest_density=fl["rest_density"], dynamic_viscosity=fl["dynamic_viscosity"],
            eos_stiffness=fl["eos_stiffness"], eos_power=fl["eos_power"],
            pressure_floor=fl["pressure_floor"])


@dataclasses.dataclass
class State:
    pos: torch.Tensor
    vel: torch.Tensor
    C: torch.Tensor
    mass: torch.Tensor
    ids: torch.Tensor
    lost: int = 0
    ceiling: int = 0


class _Geom:
    """Index helpers of an array grid (nx, wy, nz) inside the domain."""

    def __init__(self, p: Params, wy: int, device, cdt):
        nx, _, nz = p.grid
        self.res = (nx, wy, nz)
        self.c = nx * wy * nz
        self.strides = (wy * nz, nz, 1)
        self.halo = sum(self.strides)
        i = torch.arange(self.c, device=device)
        self.coord_i = torch.stack([i // self.strides[0], (i // nz) % wy, i % nz])
        self.coord = self.coord_i.to(cdt)  # [3, C]
        self.offs = [sum((t[a] - 1) * self.strides[a] for a in range(3)) for t in TAPS]


def _f(x, like):
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _pad(x, h):
    return F.pad(x, (h, h))


def _at(padded, h, off, c):
    """x[..., cell + off] from x padded by h along the cell axis."""
    return padded[..., h + off:h + off + c]


def _ksum(x):
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc


def _w_axis(t, d):
    if t == 0:
        u = 0.5 - d
        return 0.5 * (u * u)
    if t == 1:
        return 0.75 - d * d
    u = 0.5 + d
    return 0.5 * (u * u)


def _weight(d, tap):
    return _w_axis(tap[0], d[0]) * _w_axis(tap[1], d[1]) * _w_axis(tap[2], d[2])


def _dist(d, tap):
    off = torch.tensor([float(t - 1) for t in tap], dtype=d.dtype, device=d.device)
    return off.reshape(3, *([1] * (d.ndim - 1))) - d


def _mv(M, v):
    return torch.stack([M[i, 0] * v[0] + M[i, 1] * v[1] + M[i, 2] * v[2] for i in range(3)])


def _mtv(M, v):
    return torch.stack([M[0, i] * v[0] + M[1, i] * v[1] + M[2, i] * v[2] for i in range(3)])


def _pow(x, p):
    if float(p).is_integer() and 0 < p <= 32:
        n, out, base = int(p), None, x
        while n:
            if n & 1:
                out = base if out is None else out * base
            n >>= 1
            if n:
                base = base * base
        return out
    return torch.pow(x, p)


def _clip(x, lo, hi):
    lo = lo if torch.is_tensor(lo) else _f(lo, x)
    hi = hi if torch.is_tensor(hi) else _f(hi, x)
    return torch.fmin(torch.fmax(x, lo), hi)


def _p2g(pos, vel, Cm, mass, p: Params, g: _Geom):
    h, c = g.halo, g.c
    center = g.coord + 0.5
    pp, vp, cp, mp = _pad(pos, h), _pad(vel, h), _pad(Cm, h), _pad(mass, h)
    gmass = torch.zeros(c, dtype=pos.dtype, device=pos.device)
    gmom = torch.zeros(3, c, dtype=pos.dtype, device=pos.device)
    # pass 1: node c gathers bucket c + off with the reflected tap
    for tap, off in zip(TAPS, g.offs):
        ov = torch.tensor([float(t - 1) for t in tap], dtype=pos.dtype,
                          device=pos.device).reshape(3, 1, 1)
        P, M = _at(pp, h, off, c), _at(mp, h, off, c)
        V, CB = _at(vp, h, off, c), _at(cp, h, off, c)
        tr = tuple(2 - t for t in tap)
        d = P - (center[:, None, :] + ov)
        w = _weight(d, tr) * (M > 0)
        m_c = w * M
        gmass = gmass + _ksum(m_c)
        gmom = gmom + _ksum(m_c * (V + _mv(CB, _dist(d, tr))))
    # density, EOS, eq. 16 coefficients
    gm_p = _pad(gmass, h)
    d_own = pos - center[:, None, :]
    dens = torch.zeros_like(mass)
    for tap, off in zip(TAPS, g.offs):
        dens = dens + _weight(d_own, tap) * _at(gm_p, h, off, c)[None, :]
    occ = mass > 0
    sd = torch.where(occ, dens, _f(1.0, dens))
    vol = torch.where(occ, mass / sd, _f(0.0, dens))
    ratio = sd / _f(p.rest_density, sd)
    rp = _pow(ratio, p.eos_power_static) if p.eos_power_static else torch.pow(ratio, p.eos_power)
    press = torch.maximum(_f(p.pressure_floor, rp), p.eos_stiffness * (rp - 1.0))
    coef = (-4.0 * p.dt) * vol
    a_p, b_mu = coef * (-press), coef * p.dynamic_viscosity
    # pass 2: pressure and viscous force momentum
    ap_p, bm_p = _pad(a_p, h), _pad(b_mu, h)
    for tap, off in zip(TAPS, g.offs):
        ov = torch.tensor([float(t - 1) for t in tap], dtype=pos.dtype,
                          device=pos.device).reshape(3, 1, 1)
        P, M, CB = _at(pp, h, off, c), _at(mp, h, off, c), _at(cp, h, off, c)
        tr = tuple(2 - t for t in tap)
        d = P - (center[:, None, :] + ov)
        w = _weight(d, tr) * (M > 0)
        dist = _dist(d, tr)
        S = _mv(CB, dist) + _mtv(CB, dist)
        gmom = gmom + _ksum(w * (_at(ap_p, h, off, c) * dist + _at(bm_p, h, off, c) * S))
    return gmass, gmom


def _grid_update(gmass, gmom, p: Params, g: _Geom):
    has = gmass > 0
    sm = torch.where(has, gmass, _f(1.0, gmass))
    # dt * gravity rounded in float32, as the configuration's float32 scalars
    dtg = torch.tensor(p.dt, dtype=torch.float32) * torch.tensor(p.gravity, dtype=torch.float32)
    gvel = gmom / sm + dtg.to(gmom.device, gmom.dtype)[:, None]
    rows = []
    for a in range(3):
        band = (g.coord_i[a] < p.bc_band_lo) | (g.coord_i[a] > p.grid[a] - 1 - p.bc_band_hi)
        rows.append(torch.where(band, _f(0.0, gvel), gvel[a]))
    return torch.where(has, torch.stack(rows), _f(0.0, gvel))


def _g2p_tail(pos, mass, gvel, p: Params, g: _Geom):
    h, c = g.halo, g.c
    center = g.coord + 0.5
    d_own = pos - center[:, None, :]
    gv_p = _pad(gvel, h)
    vel = torch.zeros_like(pos)
    B = torch.zeros((3, *pos.shape), dtype=pos.dtype, device=pos.device)
    for tap, off in zip(TAPS, g.offs):
        wv = _weight(d_own, tap)[None] * _at(gv_p, h, off, c)[:, None, :]
        vel = vel + wv
        B = B + wv[:, None] * _dist(d_own, tap)[None]
    Cm = 4.0 * B
    res = torch.tensor(p.grid, dtype=pos.dtype, device=pos.device).reshape(3, 1, 1)
    pos = _clip(pos + vel * p.dt, _f(p.clamp_lo, pos), res - p.clamp_hi_offset)
    x_n = pos + vel
    vel = vel + p.wall_stiffness * (torch.clamp(p.wall_min - x_n, min=0.0)
                                    + torch.clamp(res - p.wall_max_offset - x_n, max=0.0))
    cell = center[:, None, :] - 0.5
    pos = _clip(pos, cell - 1.0, cell + 2.0 - CFL_EPS)
    occ = mass > 0
    pos = torch.where(occ, pos, center[:, None, :])
    vel = torch.where(occ, vel, _f(0.0, vel))
    Cm = torch.where(occ, Cm, _f(0.0, Cm))
    return pos, vel, Cm


def _shift_cells(x, off):
    if off == 0:
        return x
    return _at(_pad(x, abs(off)), abs(off), off, x.shape[-1])


def _migrate_axis(f, axis, p: Params, g: _Geom, windowed: bool):
    pos, vel, Cm, mass, ids = f["pos"], f["vel"], f["C"], f["mass"], f["ids"]
    k = mass.shape[0]
    stride = g.strides[axis]
    coord = g.coord[axis]
    occ = mass > 0
    delta = _clip(torch.floor(pos[axis]) - coord[None, :], -1.0, 1.0)
    occ0 = occ.sum(dim=0, dtype=torch.int32)
    movr, movl = occ & (delta == 1.0), occ & (delta == -1.0)
    rank_r = torch.cumsum(movr.to(torch.int32), dim=0, dtype=torch.int32) - 1
    rank_l = torch.cumsum(movl.to(torch.int32), dim=0, dtype=torch.int32) - 1
    nmovr = movr.sum(dim=0, dtype=torch.int32)
    pr_r = _shift_cells(occ0, stride)[None, :] + rank_r
    pr_l = (_shift_cells(occ0, -stride)[None, :] + _shift_cells(nmovr, -2 * stride)[None, :]
            + rank_l)
    rej = (movr & (pr_r >= k)) | (movl & (pr_l >= k))
    if axis == 1 and windowed:
        band = g.coord_i[1] >= g.res[1] - 4
        rc = movr & band[None, :] & ~rej
        f["ceiling"] += int(rc.sum())
        rej = rej | rc
    clamped = _clip(pos[axis], coord[None, :], coord[None, :] + 1.0 - CFL_EPS)
    pos = pos.clone()
    pos[axis] = torch.where(rej, clamped, pos[axis])
    delta = _clip(torch.floor(pos[axis]) - coord[None, :], -1.0, 1.0)
    cand = torch.cat([_shift_cells(occ & (delta == float(s)), -s * stride) for s in (0, 1, -1)])
    rank = torch.cumsum(cand.to(torch.int32), dim=0, dtype=torch.int32) - 1
    total = cand.sum(dim=0, dtype=torch.int32)
    f["lost"] += int(torch.clamp(total - k, min=0).sum())
    dest = torch.where(cand & (rank < k), rank, k).to(torch.int64)

    def select(x):
        cx = torch.cat([_shift_cells(x, -s * stride) for s in (0, 1, -1)], dim=-2)
        lead = cx.shape[:-2]
        out = torch.zeros((*lead, k + 1, g.c), dtype=x.dtype, device=x.device)
        out.scatter_(-2, dest.expand(*lead, 3 * k, g.c), cx)
        return out[..., :k, :]

    m = select(mass)
    f.update(pos=select(pos), vel=select(vel), C=select(Cm), mass=m,
             ids=torch.where(m > 0, select(ids), -1))


def substep(s: State, p: Params, cdt=torch.float32) -> State:
    nx, _, nz = p.grid
    wy = s.mass.shape[-1] // (nx * nz)
    g = _Geom(p, wy, s.mass.device, cdt)
    pos, mass = s.pos.to(cdt), s.mass.to(cdt)
    gmass, gmom = _p2g(pos, s.vel.to(cdt), s.C.to(cdt), mass, p, g)
    gvel = _grid_update(gmass, gmom, p, g)
    pos, vel, Cm = _g2p_tail(pos, mass, gvel, p, g)
    f = dict(pos=pos, vel=vel, C=Cm, mass=mass, ids=s.ids, lost=s.lost, ceiling=s.ceiling)
    for a in (2, 1, 0):
        _migrate_axis(f, a, p, g, windowed=wy < p.grid[1])
    return State(pos=f["pos"].float().contiguous(), vel=f["vel"].to(p.storage).contiguous(),
                 C=f["C"].to(p.storage).contiguous(), mass=f["mass"].float().contiguous(),
                 ids=f["ids"].contiguous(), lost=f["lost"], ceiling=f["ceiling"])


def run(s: State, p: Params, substeps: int, cdt=torch.float32) -> State:
    for _ in range(substeps):
        s = substep(s, p, cdt)
    return s
