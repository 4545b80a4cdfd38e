"""The splat kernels' wrappers on the CPU (render/splat.py,
render/splat_kernel.py): on CPU tensors they are the plain chain and launch
nothing; the kernels refuse CPU tensors and radii past their tile; the
dilation's tap walk of csrc/splat_dilate.cu, step for step in numpy float32
with the constants the wrapper passes, equals the plain dilation bit for
bit; and utils/roofline.dilate_work counts the benchmark cell's taps and
bytes. The kernels themselves run in tests/test_torch_cuda.py on a card.
Inputs: tests/torch_dilate_cases.py."""

import dataclasses

import numpy as np
import pytest
import torch

from mpm_tpu_torch.render import Camera, RenderConfig, render_frame_cells, splat
from mpm_tpu_torch.render import splat_kernel as ksp
from mpm_tpu_torch.render.camera import view_to_screen, world_to_view
from mpm_tpu_torch.render.splat import BG_DEPTH, SplatBuffers
from mpm_tpu_torch.utils import roofline
from torch_dilate_cases import DILATE_CASES, dilate_case, splat_pass

torch.set_num_threads(2)

FIELDS = ("depth", "velocity", "sx", "sy")


def _assert_bufs_equal(got: SplatBuffers, want: SplatBuffers) -> None:
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("case", DILATE_CASES)
def test_splat_wrappers_on_cpu_are_plain(case):
    """zbuffer_cells, velocity_key, buffers_from_zbuffer and splat_particles
    on CPU tensors: the plain chain's bits, and no launch counted."""
    k = dilate_case(case, "cpu", full_size=False)
    n0 = (ksp.zbuffer_launches, ksp.dilate_launches)
    if case == "particles":
        got = splat.splat_particles(k["pos"], k["vel"], k["view"], k["cam"], k["radius"], k["R"],
                                    with_normals=True)
        px, py, z = view_to_screen(world_to_view(k["pos"], k["view"]), k["cam"])
        want = splat._dilate_spheres(splat._point_deposit(px, py, z, k["vel"], k["cam"],
                                                          z > k["cam"].near),
                                     k["cam"], k["radius"], k["R"], with_velocity=True,
                                     with_normals=True)
        _assert_bufs_equal(got, want)
    else:
        d, key, got = splat_pass(k, splat.zbuffer_cells, splat.velocity_key,
                                 splat.buffers_from_zbuffer)
        wd, wkey, want = splat_pass(k, splat.zbuffer_cells_plain, splat.velocity_key_plain,
                                    splat.buffers_from_zbuffer_plain)
        assert torch.equal(d, wd)
        assert (key is None and wkey is None) or torch.equal(key, wkey)
        _assert_bufs_equal(got, want)
        if case != "empty":
            assert int((got.depth < BG_DEPTH).sum()) > 0
    assert (ksp.zbuffer_launches, ksp.dilate_launches) == n0 == (0, 0)


def test_splat_kernels_refuse_the_cpu_and_wide_radii():
    """The kernels launch on CUDA tensors only: a CPU tensor raises, it does
    not fall back. The renderer accepts the radii whose tile and halo fit
    the kernel's shared memory, 0 to MAX_RADIUS_PX, on every device."""
    k = dilate_case("r6_360", "cpu", full_size=False)
    with pytest.raises(ValueError, match="CUDA"):
        ksp.zbuffer(k["cells"], k["cam"])
    with pytest.raises(ValueError, match="CUDA"):
        ksp.dilate(torch.zeros(4, 4), k["cam"], 1.0, 6)
    cells = k["cells"]
    rc = RenderConfig(camera=k["cam"], max_radius_px=ksp.MAX_RADIUS_PX)
    assert render_frame_cells(cells, None, dataclasses.replace(rc, mode="none"),
                              bg=(torch.zeros(1), None)).shape == (1,)
    for bad in (-1, ksp.MAX_RADIUS_PX + 1):
        with pytest.raises(ValueError, match="max_radius_px"):
            render_frame_cells(cells, None, dataclasses.replace(rc, max_radius_px=bad),
                               bg=(torch.zeros(1), None))


def _kernel_walk(depth, cam, radius, R, vel=None, key=None, raw=False, track_v=False,
                 track_n=False):
    """csrc/splat_dilate.cu's dilation in numpy float32: the loader's decode
    and Q, the start, the (2R+1)^2 - 1 taps dy then dx ascending with the
    taps of r^2 - Q c < 0 (and of empty sources) and those past the reach of
    the pixel's 32 x 8 tile skipped, the untracked min from +inf where the
    start is NaN, the tracked strict less-than, and the winner's velocity
    and offsets."""
    f32 = np.float32
    focal, r, r2, q_clamp, inv_r = (f32(x) for x in ksp.dilate_constants(cam, radius, R))
    d = depth.numpy()
    if raw:
        d = np.where(d < BG_DEPTH, d, f32(BG_DEPTH))
    h, w = d.shape
    occ = d < BG_DEPTH
    with np.errstate(all="ignore"):
        t = d / focal
        q = np.where(occ, np.maximum(t * t, q_clamp), f32(np.inf)).astype(f32)
    pd = np.full((h + 2 * R, w + 2 * R), BG_DEPTH, f32)
    pq = np.full((h + 2 * R, w + 2 * R), np.inf, f32)
    pd[R:R + h, R:R + w], pq[R:R + h, R:R + w] = d, q
    with np.errstate(all="ignore"):
        best = np.where(occ, d - r, d).astype(f32)
    reach = np.zeros((h, w), np.int64)  # each tile's, from the least Q of its tile and halo
    for ty in range(0, h, 8):
        for tx in range(0, w, 32):
            qmin = pq[ty:ty + 8 + 2 * R, tx:tx + 32 + 2 * R].min()
            k = R
            with np.errstate(all="ignore"):
                while k > 0 and not r2 - qmin * f32(k * k) >= 0:
                    k -= 1
            reach[ty:ty + 8, tx:tx + 32] = k
    tracked = track_v or track_n
    if not tracked:
        best = np.where(np.isnan(best), f32(np.inf), best)
    wdx = np.zeros((h, w), np.int64)
    wdy = np.zeros((h, w), np.int64)
    won = np.zeros((h, w), bool)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            if not (dx or dy):
                continue
            sd = pd[R - dy:R - dy + h, R - dx:R - dx + w]
            sq = pq[R - dy:R - dy + h, R - dx:R - dx + w]
            with np.errstate(all="ignore"):
                tt = r2 - sq * f32(dx * dx + dy * dy)
                ok = (tt >= 0) & (max(abs(dx), abs(dy)) <= reach)
                o = sd - np.sqrt(np.where(ok, tt, f32(0)))
            if tracked:
                take = ok & (o < best)
                best = np.where(take, o, best)
                wdx, wdy, won = np.where(take, dx, wdx), np.where(take, dy, wdy), won | take
            else:
                best = np.where(ok, np.fmin(best, o), best)
    out = {"depth": best}
    ys, xs = np.mgrid[0:h, 0:w]
    sy_, sx_ = ys - wdy, xs - wdx  # the winner, or the pixel itself
    if track_v:
        if raw:
            k = key.numpy()
            dec = (k & 0xFFF).astype(f32) * f32(1.0 / 64.0)
            out["velocity"] = np.where(won | occ, dec[sy_, sx_], f32(0))
        else:
            out["velocity"] = vel.numpy()[sy_, sx_]
    if track_n:
        s = np.where(won, np.sqrt(pq[sy_ + R, sx_ + R]) * inv_r, f32(0))
        out["sx"] = np.where(won, wdx.astype(f32) * s, f32(0))
        out["sy"] = np.where(won, wdy.astype(f32) * s, f32(0))
    return out


def _assert_walk_equal(walk: dict, want: SplatBuffers) -> None:
    for f in FIELDS:
        if getattr(want, f) is not None:
            np.testing.assert_array_equal(walk[f], getattr(want, f).numpy(), err_msg=f)
        else:
            assert f not in walk


@pytest.mark.parametrize("case", DILATE_CASES)
def test_kernel_tap_walk_equals_plain_dilation(case):
    """The kernel's walk (skipped taps, a NaN start, ties broken by the
    strict less-than in dy-then-dx order) gives the plain dilation's bits:
    on the z-buffers of each case (decoded as the kernel decodes), and on
    the particle array's deposit (depth and velocity as they are)."""
    k = dilate_case(case, "cpu", full_size=False)
    if case == "particles":
        px, py, z = view_to_screen(world_to_view(k["pos"], k["view"]), k["cam"])
        bufs = splat._point_deposit(px, py, z, k["vel"], k["cam"], z > k["cam"].near)
        want = splat._dilate_spheres(bufs, k["cam"], k["radius"], k["R"], with_velocity=True,
                                     with_normals=True)
        walk = _kernel_walk(bufs.depth, k["cam"], k["radius"], k["R"], vel=bufs.velocity,
                            track_v=True, track_n=True)
    else:
        d, key, want = splat_pass(k, splat.zbuffer_cells_plain, splat.velocity_key_plain,
                                  splat.buffers_from_zbuffer_plain)
        walk = _kernel_walk(d, k["cam"], k["radius"], k["R"], key=key, raw=True,
                            track_v=k["velocity"], track_n=k["normals"])
    _assert_walk_equal(walk, want)


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("radius, R", [(1.0, 6), (1.3, 5), (0.7, 0), (2.0, 2)])
def test_kernel_tap_walk_on_odd_depths(tracked, radius, R):
    """The walk against _dilate_spheres on a depth buffer as given (not
    decoded): depths past BG_DEPTH, NaN, -inf, +inf, negative and 0 among
    seeded ones, sphere radii whose squares round, and R 0."""
    rng = np.random.default_rng(R + int(10 * radius))
    cam = Camera(width=40, height=24)
    d = rng.uniform(1.0, 80.0, (24, 40)).astype(np.float32)
    d[rng.random((24, 40)) < 0.5] = BG_DEPTH
    d[3, 5], d[7, 9], d[10, 10], d[12, 30], d[20, 4], d[15, 15], d[1, 1] = (
        np.nan, -np.inf, np.inf, -3.5, 0.0, 5000.0, 0.01)
    depth = torch.from_numpy(d)
    vel = torch.from_numpy(rng.uniform(0, 9, (24, 40)).astype(np.float32))
    bufs = SplatBuffers(depth=depth, velocity=vel)
    want = splat._dilate_spheres(bufs, cam, radius, R, with_velocity=tracked,
                                 with_normals=tracked)
    walk = _kernel_walk(depth, cam, radius, R, vel=vel, track_v=tracked, track_n=tracked)
    want = want._replace(velocity=want.velocity if tracked else None)
    _assert_walk_equal(walk, want)


def test_dilate_constants_round_as_the_plain_chain():
    """The dilation's constants, passed by value: float32 of the focal
    length (the plain chain's device tensor), of r (its subtraction), r^2
    and r^2 / R^2 (its Python operands) and 1 / r, computed on the host
    from the camera and the call; R = 0 clamps at 1, as the plain loop."""
    cam = Camera(width=160, height=96)
    got = ksp.dilate_constants(cam, 1.1, 7)
    r2 = 1.1 * 1.1
    assert got == tuple(float(torch.tensor(v, dtype=torch.float32)) for v in (
        cam.focal_px, 1.1, r2, r2 / 49.0, 1.0 / 1.1))
    assert got[0] == float(torch.tensor(cam.focal_px, dtype=torch.float32))
    assert ksp.dilate_constants(cam, 1.0, 0)[3] == 1.0
    assert all(isinstance(v, float) for v in got)


def test_dilate_work_counts_the_cell():
    """utils/roofline.dilate_work at the benchmark cell's crop (992 x 1024)
    and R 6: 168 taps a pixel, the buffer in and out once, and one square
    root for each tap inside an occupied source's disc and the crop (a
    source at the crop's corner offers to a quarter of its disc)."""
    cam = Camera(width=1920, height=1080)
    depth = torch.full((992, 1024), BG_DEPTH)
    depth[500, 600] = 50.0  # Q is the clamp 1/36: the disc of radius 6
    depth[0, 0] = 50.0
    nbytes, ops, roots = roofline.dilate_work(depth, cam, 1.0, 6)
    assert nbytes == 2 * 4 * 992 * 1024 == 8_126_464
    taps = 992 * 1024 * 168
    q = np.float32(np.float32(1.0) / np.float32(36.0))
    disc = [(dx, dy) for dy in range(-6, 7) for dx in range(-6, 7) if (dx or dy)
            and np.float32(1.0) - q * np.float32(dx * dx + dy * dy) >= 0]
    assert roots == len(disc) + sum(dx >= 0 and dy >= 0 for dx, dy in disc)
    assert 108 <= len(disc) <= 112
    assert ops == (992 * 1024 * roofline.DILATE_PIXEL_OPS + taps * roofline.DILATE_TAP_OPS
                   + roots * roofline.DILATE_DISC_OPS)
    assert roofline.zbuffer_work(torch.zeros(5, 10), 4, 8) == (120 + 128, 100)
