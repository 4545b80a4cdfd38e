"""The port's thickness pass (render/splat.thickness_deposit and
ssfr.thickness_map feeding Beer's law and the refraction offset), the
particle-array splat (splat_particles), the sharded composites of every
mode on 2 CPU slabs, and the `render` CLI's new flags, after
tests/test_thickness.py and tests/test_dist_render.py.

Bars: the deposit against the JAX package's per pixel within rtol 1e-6 and
the same bits on two calls; the material it deposits and the blur's total
as tests/test_thickness.py:42-66 has them; the sharded velocity, lit and
depth frames equal the single-device frames bit for bit (min composites
over disjoint cells are exact); the sharded thickness frame within a mean
|du8| of 0.5 of the single-device frame and more than 0.1 from the
constant-thickness frame (tests/test_dist_render.py:131-165: its deposit is
a sum in another order); the particle splat as stated at its tests."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mpm_tpu.render import Camera as JCamera
from mpm_tpu.render import splat as jsplat
from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.core.params import FluidParams, SimConfig
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.models.emitters import box_lattice
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.parallel.render import make_sharded_frame_step
from mpm_tpu_torch.render import (Camera, RenderConfig, SSFRParams, background_for_view,
                                  frame_to_u8, make_full_frame_step, render_frame_buckets)
from mpm_tpu_torch.render import image, splat, ssfr
from mpm_tpu_torch.render.camera import look_at
from mpm_tpu_torch.render.extract_kernel import CELL_BG, extract_cell_splats_plain

torch.set_num_threads(2)

VIEW = torch.from_numpy(look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0)))
CAM = Camera(width=128, height=96)
JCAM = JCamera(width=128, height=96)


def _setup(grid=(16, 16, 16), box=(10.0, 6.0, 10.0), center=(8.0, 6.0, 8.0)):
    """tests/test_thickness.py:32-39's lattice as a port bucket state."""
    pos = box_lattice(grid, box, 0.8, center=center)
    config = SimConfig(grid_res=grid, num_particles=pos.shape[0], substeps=2, bin_capacity=8)
    return config, tb.from_simstate(make_state(pos, "cpu"), config)


def _mean_du8(a, b) -> float:
    return float((a.int() - b.int()).abs().float().mean())


def test_deposit_matches_jax_and_is_deterministic():
    """Seeded splat points (a fifth empty, some off the frame), in the frame
    and in a crop: per pixel within rtol 1e-6 of the JAX deposit, the same
    bits on a second call."""
    rng = np.random.default_rng(11)
    m = 4000
    cells = np.stack([rng.uniform(-5, 133, m), rng.uniform(-5, 101, m), rng.uniform(5, 60, m),
                      rng.uniform(0, 80, m), rng.integers(1, 9, m)]).astype(np.float32)
    cells[2, rng.random(m) < 0.2] = 1e9
    jcam = JCamera(width=128, height=96)
    for crop in (None, (8, 16, 64, 96)):
        got = splat.thickness_deposit(torch.tensor(cells), CAM, 1.0, crop)
        want = jax.jit(lambda c, crop=crop: jsplat.thickness_deposit(c, jcam, 1.0, crop))(cells)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        assert torch.equal(got, splat.thickness_deposit(torch.tensor(cells), CAM, 1.0, crop))
        assert int((got > 0).sum()) > 1000


def test_deposit_conserves_material():
    """tests/test_thickness.py:42-66: the deposit is count * 2r * (f / z)^2
    summed over the live on-screen cells (rtol 1e-5), every live cell counts
    at least one particle, and the normalised blur keeps the total (rtol
    1e-4)."""
    _, b = _setup()
    cells = extract_cell_splats_plain(b, VIEW, CAM)
    t = splat.thickness_deposit(cells, CAM, sphere_radius=1.0)
    c = cells.double().numpy()
    on = ((np.floor(c[0]) >= 0) & (np.floor(c[0]) < CAM.width) & (np.floor(c[1]) >= 0)
          & (np.floor(c[1]) < CAM.height) & (c[2] < CELL_BG))
    expect = (2.0 * c[4][on] * (CAM.focal_px / c[2][on]) ** 2).sum()
    np.testing.assert_allclose(float(t.double().sum()), expect, rtol=1e-5)
    assert c[4][on].sum() >= on.sum() > 100
    np.testing.assert_allclose(float(ssfr.gaussian_blur(t, 6).double().sum()),
                               float(t.double().sum()), rtol=1e-4)


def test_default_off_is_reference_exact():
    """thickness_pass=False leaves the frame as it was: the thickness knobs
    change nothing when the pass is off."""
    config, b = _setup()
    rc0 = RenderConfig(camera=CAM)
    assert rc0.ssfr.thickness_pass is False
    rc1 = RenderConfig(camera=CAM, ssfr=SSFRParams(thickness_scale=99.0, thickness_blur_radius=1))
    assert torch.equal(render_frame_buckets(b, VIEW, rc0), render_frame_buckets(b, VIEW, rc1))


def test_thickness_darkens_thick_columns():
    """tests/test_thickness.py:83-111: without the refraction offset, the
    pass changes more than 1% of the frame, and where it does the frame is
    not brighter than the constant-thickness one (the map is at least the
    constant) on more than 95% of the pixels."""
    _, b = _setup(box=(10.0, 10.0, 10.0), center=(8.0, 8.0, 8.0))
    off = render_frame_buckets(b, VIEW, RenderConfig(
        camera=CAM, ssfr=SSFRParams(refraction_strength=0.0))).double()
    on = render_frame_buckets(b, VIEW, RenderConfig(
        camera=CAM, ssfr=SSFRParams(refraction_strength=0.0, thickness_pass=True,
                                    thickness_scale=0.3))).double()
    diff = (on - off).abs().sum(-1)
    fluid = diff > 1e-3
    assert float(fluid.double().mean()) > 0.01
    assert float((on.sum(-1)[fluid] <= off.sum(-1)[fluid] + 1e-6).double().mean()) > 0.95


def test_deposit_blur_matches_analytic_column():
    """tests/test_thickness.py:140-173: a solid lattice box 10 deep, seen
    head-on at spacing 1 with r = 0.5, reads its depth extent on the
    central quarter of its projection after the footprint weights and the
    blur: mean relative error under 0.15, largest under 0.35."""
    extent = 10.0
    pos = box_lattice((24, 24, 24), (12.0, 12.0, extent), 1.0, center=(12.0, 12.0, 12.0))
    config = SimConfig(grid_res=(24, 24, 24), num_particles=pos.shape[0], substeps=2,
                       bin_capacity=8)
    b = tb.from_simstate(make_state(pos, "cpu"), config)
    cam = Camera(width=160, height=120)
    view = torch.from_numpy(look_at((12.0, 12.0, 60.0), (12.0, 12.0, 12.0)))
    t = splat.thickness_deposit(extract_cell_splats_plain(b, view, cam), cam, sphere_radius=0.5)
    tb_ = ssfr.gaussian_blur(t, 6).numpy()
    half_px = int(0.25 * 6.0 * cam.focal_px / (60.0 - 12.0 - extent / 2.0))
    cy, cx = cam.height // 2, cam.width // 2
    err = np.abs(tb_[cy - half_px:cy + half_px + 1, cx - half_px:cx + half_px + 1] - extent) / extent
    assert err.mean() < 0.15 and err.max() < 0.35, (err.mean(), err.max())


def test_particle_quality_thickness_rides_cell_splats():
    """Under quality "particle" the deposit takes the cell splats: kernel
    F's emission in make_full_frame_step, kernel X's extraction in
    render_frame_buckets, which are equal, so the two frames are too; the
    pass changes the frame."""
    config, b = _setup()
    fluid = FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0)
    rc = RenderConfig(camera=CAM, quality="particle",
                      ssfr=SSFRParams(thickness_pass=True, thickness_scale=0.3))
    bg = background_for_view(rc, VIEW, "cpu")
    b1, img = make_full_frame_step(config, rc, 2)(b, fluid, (), VIEW, bg)
    assert torch.equal(img, frame_to_u8(render_frame_buckets(b1, VIEW, rc, bg=bg)))
    const = frame_to_u8(render_frame_buckets(b1, VIEW, RenderConfig(camera=CAM,
                                                                    quality="particle"), bg=bg))
    assert _mean_du8(img, const) > 0.1


def test_point_deposit_bit_equal():
    """The sorted point deposit of splat_particles, from the same pixel
    coordinates, depths and keep mask: depth and velocity bit for bit."""
    rng = np.random.default_rng(6)
    n = 6000
    px, py = rng.uniform(-3, 131, n), rng.uniform(-3, 99, n)
    depth = rng.choice(rng.uniform(20, 60, n // 4), n)  # repeated depths: ties
    args = [a.astype(np.float32) for a in (px, py, depth, rng.uniform(0, 30, n))]
    keep = (np.arange(n) % 3) > 0
    got = splat._point_deposit(*(torch.tensor(a) for a in args), CAM, torch.tensor(keep))
    want = jax.jit(lambda *a: jsplat._point_deposit(*a[:4], JCAM, a[4]))(*args, keep)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.velocity.numpy(), np.asarray(want.velocity))
    assert int((got.depth < splat.BG_DEPTH).sum()) > 2000


def test_splat_particles_matches_jax():
    """The whole splat at sphere_render_ratio 0.5 (the projection included:
    XLA's matrix product rounds differently) on all but 0.5% of the pixels
    within rtol 1e-6; the ratio keeps half the particles."""
    rng = np.random.default_rng(6)
    n = 4000
    pos = np.stack([rng.uniform(2, 14, n), rng.uniform(2, 8, n), rng.uniform(2, 14, n)])
    pos = pos.astype(np.float32)
    vmag = rng.uniform(0, 30, n).astype(np.float32)
    b = splat.splat_particles(torch.tensor(pos), torch.tensor(vmag), VIEW, CAM, 1.0, 3, 0.5)
    jbuf = jax.jit(lambda p, v: jsplat.splat_particles(p, v, jnp.asarray(VIEW.numpy()), JCAM,
                                                       1.0, 3, 0.5))(pos, vmag)
    for f in ("depth", "velocity"):
        off = ~np.isclose(getattr(b, f).numpy(), np.asarray(getattr(jbuf, f)), rtol=1e-6, atol=0)
        assert off.mean() <= 0.005, (f, off.mean())
    full = splat.splat_particles(torch.tensor(pos), torch.tensor(vmag), VIEW, CAM, 1.0, 3)
    assert 200 < int((b.depth < splat.BG_DEPTH).sum()) < int((full.depth < splat.BG_DEPTH).sum())


def _sharded_pair(rc):
    """One frame (2 substeps, emission, composite, render) on 2 CPU slabs
    and make_full_frame_step's frame from the same state."""
    config, b = _setup()
    fluid = FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0)
    bg = background_for_view(rc, VIEW, "cpu")
    mesh = domain.SlabMesh.on("cpu", 2)
    step = make_sharded_frame_step(config, mesh, rc)
    sb = domain.shard_bucket_state(b, config, mesh)
    out, img = step(sb, fluid, (), VIEW, bg)
    _, want = make_full_frame_step(config, rc, config.substeps)(b, fluid, (), VIEW, bg)
    assert int(out.lost) == 0 and img.shape == (96, 128, 3)
    return img, want, step, sb, fluid, bg


@pytest.mark.parametrize("mode", ["velocity_spheres", "lit_spheres", "depth_debug"])
def test_sharded_mode_frame_bit_equal(mode):
    """The velocity key and the depth composite by a min: the sharded frame
    equals the single-device frame bit for bit."""
    img, want, *_ = _sharded_pair(RenderConfig(camera=CAM, mode=mode))
    assert torch.equal(img, want)


def test_sharded_thickness_frame():
    """The deposits composite by a sum in slab order: within a mean |du8|
    of 0.5 of the single-device frame, more than 0.1 from the constant
    frame, and the same bits on a second call."""
    rc = RenderConfig(camera=CAM, ssfr=SSFRParams(thickness_pass=True, thickness_scale=0.3))
    img, want, step, sb, fluid, bg = _sharded_pair(rc)
    assert _mean_du8(img, want) < 0.5
    assert torch.equal(step(sb, fluid, (), VIEW, bg)[1], img)
    const, *_ = _sharded_pair(RenderConfig(camera=CAM))
    assert _mean_du8(img, const) > 0.1


@pytest.fixture(scope="module")
def cli_base(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    return out, _cli(out, "base")


def _cli(tmp, name, *extra):
    """One 96 x 64 frame of `render fluid_3d_fixed_point` (4,096 particles)
    on the CPU."""
    out = tmp / name
    main(["render", "fluid_3d_fixed_point", "--device", "cpu", "--mode", "bucketed", "--frames", "1",
          "--substeps", "1", "--width", "96", "--height", "64", "--out", str(out), *extra])
    pngs = sorted(out.glob("*.png"))
    assert [p.name for p in pngs] == ["frame_00000.png"]
    img = image.read_png_rgb(str(pngs[0]))
    assert img.shape == (64, 96, 3)
    return img


def test_render_cli_modes_and_ratio(cli_base, capsys):
    """--render-mode velocity_spheres, and --sphere-render-ratio 0.5 (the
    particle-array path) with lit spheres, each change the frame;
    legacy_quad with a ratio below 1 (it reads the bucket state's texture)
    and --shards with a ratio below 1 or mode none are refused."""
    tmp, base = cli_base
    assert not np.array_equal(_cli(tmp, "velocity", "--render-mode", "velocity_spheres"), base)
    assert not np.array_equal(_cli(tmp, "ratio", "--sphere-render-ratio", "0.5",
                                   "--render-mode", "lit_spheres"), base)
    text = capsys.readouterr().out
    assert "render-mode=velocity_spheres" in text and "sphere-render-ratio=0.5" in text
    with pytest.raises(SystemExit, match="legacy_quad reads the bucket-state texture"):
        _cli(tmp, "legacy", "--render-mode", "legacy_quad", "--sphere-render-ratio", "0.5")
    for extra, msg in ((["--sphere-render-ratio", "0.5"], "--sphere-render-ratio 1.0"),
                       (["--render-mode", "none"], "a drawing --render-mode")):
        with pytest.raises(SystemExit, match=msg):
            _cli(tmp, "shards", "--shards", "2", *extra)


def test_render_cli_thickness_and_cubemap(cli_base, capsys):
    """--thickness-pass (at the CLI's default --thickness-scale 0.35) and
    --cubemap DIR (six gradient faces) each change the frame."""
    tmp, base = cli_base
    assert not np.array_equal(_cli(tmp, "thick", "--thickness-pass"), base)
    faces = tmp / "faces"
    faces.mkdir()
    ramp = np.linspace(0, 255, 32).astype(np.uint8)
    for i in range(1, 7):
        face = np.stack([np.broadcast_to(ramp[:, None], (32, 32)),
                         np.full((32, 32), 40 * i, np.uint8),
                         np.broadcast_to(ramp[None, ::-1], (32, 32))], -1)
        image.write_png(str(faces / f"sky-{i}.png"), np.ascontiguousarray(face))
    assert not np.array_equal(_cli(tmp, "cube", "--cubemap", str(faces)), base)
    text = capsys.readouterr().out
    assert "thickness-pass=True" in text and f"cubemap={faces}" in text
