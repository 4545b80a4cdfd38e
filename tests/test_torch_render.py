"""The port's render path (mpm_tpu_torch.render) against the JAX package's on
the CPU: camera and crop, background, z-buffer and dilation, surface bands,
whole frames at equal blur caps, the crop's bit-exactness, and the `render`
CLI. States come from the JAX package through convert.py; frames are
compared by the share of pixels that differ by more than 1 LSB."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.core.params import FluidParams as JFluidParams
from mpm_tpu.core.params import SimConfig as JSimConfig
from mpm_tpu.core.state import make_state as jmake_state
from mpm_tpu.models.emitters import box_lattice
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.render import Camera as JCamera
from mpm_tpu.render import RenderConfig as JRenderConfig
from mpm_tpu.render import SSFRParams as JSSFRParams
from mpm_tpu.render import background as jbackground
from mpm_tpu.render import camera as jcamera
from mpm_tpu.render import pipeline as jpipeline
from mpm_tpu.render import splat as jsplat
from mpm_tpu.render.extract_kernel import extract_cell_splats as jextract
from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.render import (Camera, RenderConfig, SSFRParams, background_for_view,
                                  domain_crop, frame_to_u8, make_full_frame_step,
                                  render_frame_buckets)
from mpm_tpu_torch.render import background, camera, image, splat
from mpm_tpu_torch.render.extract_kernel import extract_cell_splats
from test_torch_render_kernels import to_port

torch.set_num_threads(2)

GRID = (16, 16, 16)
CAM = (384, 256)
VIEW = jcamera.look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0))
BANDS = (5, 4, 4)
MAX_OFF_SHARE = 0.001  # frames: at most 0.1% of pixels off by more than 1 LSB


def _pool(full_height=True):
    """tests/test_band_extract.py's wall-to-wall pool: full height puts the
    free surface in the top band; half height leaves it mid-grid."""
    size = (11.5, 11.0, 11.5) if full_height else (11.5, 5.5, 11.5)
    cy = 8.0 if full_height else 5.2
    pos = box_lattice(GRID, size, 0.8, center=(8.0, cy, 8.0))
    jcfg = JSimConfig(grid_res=GRID, num_particles=pos.shape[0], substeps=2,
                      bin_capacity=8)
    jfluid = JFluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0)
    js = jax.jit(lambda s: jb.from_simstate(s, jcfg))(jmake_state(pos))
    return jcfg, jfluid, js


@pytest.fixture(scope="module")
def pool():
    return _pool()


def _cams(w=CAM[0], h=CAM[1]):
    return Camera(width=w, height=h), JCamera(width=w, height=h)


def _rcs(**kw):
    """Port and JAX RenderConfigs at equal blur caps (12: the JAX CPU
    path's tap radius)."""
    cam, jcam = _cams()
    return (RenderConfig(camera=cam, ssfr=SSFRParams(max_filter_size=12), **kw),
            JRenderConfig(camera=jcam, ssfr=JSSFRParams(max_filter_size=12,
                                                        blur_tap_radius=12), **kw))


def _off_share(got: torch.Tensor, want) -> float:
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    return float((d.max(axis=-1) > 1).mean())


def _fluid_share(img: torch.Tensor, rc, view) -> float:
    bg = frame_to_u8(background_for_view(rc, view, "cpu")[0])
    return float(((img.int() - bg.int()).abs().amax(-1) > 2).float().mean())


@pytest.mark.parametrize("eye,target", [((40.0, 30.0, 40.0), (8.0, 6.0, 8.0)),
                                        ((-30.0, 50.0, 10.0), (8.0, 6.0, 8.0)),
                                        ((8.0, 6.0, 8.0), (0.0, 0.0, 0.0))])
def test_camera_crop_matches_jax(eye, target):
    """Equal crops (None for the camera inside the domain), so both packages
    shade the same rectangle."""
    view = jcamera.look_at(eye, target)
    np.testing.assert_array_equal(camera.look_at(eye, target), view)
    for w, h in ((512, 384), (640, 360), (1920, 1080)):
        cam, jcam = _cams(w, h)
        for margin in (14, 16):
            assert camera.crop_for_aabb(cam, view, (0, 0, 0), (16, 16, 16), margin) == \
                jcamera.crop_for_aabb(jcam, view, (0, 0, 0), (16, 16, 16), margin)
    cam, jcam = _cams(160, 96)
    crop = (8, 16, 48, 128)
    # the JAX rays as one jitted executable, copied out of JAX's buffer: in
    # the full parallel suite the first eager evaluation of a worker came
    # back up to 2.5e-4 off on about half the rays, while later calls in the
    # same worker and the port's serial CPU ops agreed to 1e-7
    want = np.array(jax.jit(lambda: jcamera.screen_to_view_dir(jcam, crop))())
    np.testing.assert_allclose(camera.screen_to_view_dir(cam, crop).numpy(), want, atol=1e-6)


def test_background_matches_jax():
    """Depth within rtol 1e-4 (near the horizon the floor's hit distance
    (floor_y - eye_y) / dir_y magnifies a last-bit difference of dir_y,
    where XLA fuses multiply-adds); colour within 1e-4 on all but 0.1% of
    the pixels (the checker's floor(p / 8) can flip there). The sampler of
    None is the sky, and a cubemap's sampler equals the JAX package's on
    the background's own directions."""
    cam, jcam = _cams()
    color, depth = background.render_background(cam, VIEW, device="cpu")
    jcolor, jdepth = jax.jit(lambda v: jbackground.render_background(jcam, v))(VIEW)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-4)
    off = np.abs(color.numpy() - np.asarray(jcolor)).max(axis=-1) > 1e-4
    assert off.mean() <= 0.001, off.mean()
    assert background.make_cubemap_sampler(None) is background.sky_color
    faces = np.random.default_rng(9).uniform(0, 1, (6, 4, 4, 3)).astype(np.float32)
    dirs = camera.screen_to_view_dir(cam) @ torch.tensor(VIEW)[:3, :3]
    np.testing.assert_array_equal(
        background.make_cubemap_sampler(torch.tensor(faces))(dirs).numpy(),
        np.asarray(jbackground.make_cubemap_sampler(jnp.asarray(faces))(jnp.asarray(dirs.numpy()))))


@pytest.mark.parametrize("crop", [None, "domain"])
def test_zbuffer_and_dilation_bit_equal(pool, crop):
    """The same splat points through both packages: the scatter-min
    z-buffer and the sphere dilation agree bit for bit."""
    jcfg, jfluid, js = pool
    cam, jcam = _cams()
    cells = np.asarray(jextract(js, jnp.asarray(VIEW), jcam, interpret=True))
    if crop == "domain":
        crop = camera.crop_for_aabb(cam, VIEW, (0, 0, 0), jcfg.dres, margin=14)
    d = splat.zbuffer_cells(torch.tensor(cells), cam, crop=crop)
    jd, _ = jsplat.zbuffer_cells(jnp.asarray(cells), jcam, with_velocity=False, crop=crop)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert int((d < splat.BG_DEPTH).sum()) > 100
    got = splat.buffers_from_zbuffer(d, cam, 1.0, 6).depth
    want = jsplat.buffers_from_zbuffer(jd, None, jcam, 1.0, 6, with_velocity=False).depth
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_rows_and_counters_match_jax(pool):
    """tests/test_band_extract.py's cases: band rows against the JAX rows
    (rtol 1e-6 atol 1e-5, live flags equal) and against the port's own full
    rows at the shell (bit for bit); the certificate, both ways, and the
    minimal top band equal to the JAX package's."""
    jcfg, jfluid, js = pool
    _, _, state = to_port(jcfg, jfluid, js)
    cam, jcam = _cams()
    band = splat.extract_band_slot_splats(state, VIEW, cam, GRID, BANDS)
    jband = np.asarray(jsplat.extract_band_slot_splats(js, jnp.asarray(VIEW), jcam, GRID,
                                                       BANDS))
    assert band.shape == jband.shape
    np.testing.assert_array_equal(band[4].numpy(), jband[4])
    np.testing.assert_allclose(band.numpy(), jband, rtol=1e-6, atol=1e-5)
    full = splat.extract_slot_splats(state, VIEW, cam)
    bt, bf, bs = BANDS
    interior = (GRID[0] - 2 * bs) * (GRID[1] - bt - bf) * (GRID[2] - 2 * bs)
    assert band.shape[1] == full.shape[1] - 8 * interior
    shell = torch.ones(GRID, dtype=torch.bool)
    shell[bs:-bs, bf:GRID[1] - bt, bs:-bs] = False
    live_full = full[:, full[2] < splat.CELL_BG]
    live_band = band[:, band[2] < splat.CELL_BG]
    keep = full[:, shell.reshape(-1).repeat(8) & (full[2] < splat.CELL_BG)]
    assert torch.equal(live_band.sort(dim=1).values, keep.sort(dim=1).values)
    assert live_band.shape[1] < live_full.shape[1]
    assert torch.equal(splat.extract_band_slot_splats(state, VIEW, cam, GRID, (8, 8, 8)),
                       full)
    for full_height in (True, False):
        jcfg2, jfluid2, js2 = _pool(full_height) if not full_height else pool
        _, _, s2 = to_port(jcfg2, jfluid2, js2)
        unc = splat.surface_band_uncovered(s2, GRID, BANDS)
        assert unc == int(jsplat.surface_band_uncovered(js2, GRID, BANDS))
        assert (unc == 0) == full_height
        top = splat.surface_band_min_top(s2, GRID, bf, bs)
        assert top == int(jsplat.surface_band_min_top(js2, GRID, bf, bs))
        assert splat.surface_band_uncovered(s2, GRID, (top, bf, bs)) == 0
        assert splat.surface_band_uncovered(s2, GRID, (top - 1, bf, bs)) > 0


def test_full_frame_step_cell_matches_jax(pool):
    """make_full_frame_step at cell quality (two plain substeps, the second
    emitting the splats) against the JAX bucket engine's two substeps, the
    extraction of its state and JAX's render_frame_cells."""
    jcfg, jfluid, js = pool
    cfg, fluid, state = to_port(jcfg, jfluid, js)
    rc, jrc = _rcs()
    bg = background_for_view(rc, VIEW, "cpu")
    state1, img = make_full_frame_step(cfg, rc, 2)(state, fluid, (), VIEW, bg)
    step = jax.jit(lambda s: jb.substep(s, jcfg, jfluid))
    js1 = step(step(js))
    np.testing.assert_allclose(state1.pos.numpy(), np.asarray(js1.pos), atol=1e-6)
    jcells = jextract(js1, jnp.asarray(VIEW), jrc.camera, interpret=True)
    jimg = jax.jit(lambda c, v: jpipeline.frame_to_u8(
        jpipeline.render_frame_cells(c, v, jrc)))(jcells, VIEW)
    share = _off_share(img, jimg)
    print(f"cell quality: {share:.5f} of pixels off by more than 1 LSB")
    assert share <= MAX_OFF_SHARE
    assert _fluid_share(img, rc, VIEW) > 0.01


def test_particle_bands_frame_matches_jax(pool):
    """render_frame_buckets at particle quality with surface bands against
    the JAX package's, and the banded frame against the port's unbanded
    one (at most 5 pixels apart, tests/test_band_extract.py's bar)."""
    jcfg, jfluid, js = pool
    _, _, state = to_port(jcfg, jfluid, js)
    rc, jrc = _rcs(quality="particle", surface_bands=BANDS)
    img = frame_to_u8(render_frame_buckets(state, VIEW, rc, grid_res=GRID))
    jimg = jax.jit(lambda s, v: jpipeline.frame_to_u8(jpipeline.render_frame_buckets(
        s, v, jrc, interpret=True, grid_res=GRID)))(js, VIEW)
    share = _off_share(img, jimg)
    print(f"particle quality with bands: {share:.5f} of pixels off by more than 1 LSB")
    assert share <= MAX_OFF_SHARE
    unbanded = frame_to_u8(render_frame_buckets(state, VIEW, dc.replace(rc, surface_bands=None)))
    assert int((img != unbanded).any(dim=-1).sum()) <= 5
    with pytest.raises(ValueError, match="grid_res"):
        render_frame_buckets(state, VIEW, rc)


@pytest.mark.parametrize("quality", ["cell", "particle"])
def test_crop_frame_bit_exact(quality):
    """tests/test_crop.py:78's claim in the port: the frame with the domain
    crop equals the frame without, bit for bit."""
    pos = box_lattice(GRID, (10.0, 6.0, 10.0), 0.8, center=(8.0, 6.0, 8.0))
    jcfg = JSimConfig(grid_res=GRID, num_particles=pos.shape[0], substeps=2, bin_capacity=8)
    js = jax.jit(lambda s: jb.from_simstate(s, jcfg))(jmake_state(pos))
    cfg, _, state = to_port(jcfg, JFluidParams.create(dim=3), js)
    rc = RenderConfig(camera=Camera(width=512, height=384), quality=quality,
                      ssfr=SSFRParams(max_filter_size=12))
    rc_crop = domain_crop(rc, cfg, VIEW)
    assert rc_crop.crop is not None
    assert rc_crop.crop == jpipeline.domain_crop(JRenderConfig(camera=JCamera(512, 384)),
                                                 jcfg, VIEW).crop
    full = render_frame_buckets(state, VIEW, rc)
    assert torch.equal(render_frame_buckets(state, VIEW, rc_crop), full)


def test_modes_not_ported_raise(pool):
    """Every mode is ported: legacy_quad raises only without the particle
    count its texture needs, as the JAX package's does, and renders with
    it; the velocity, lit-sphere and depth modes render a frame that
    differs from the background; "none" is the background."""
    jcfg, jfluid, js = pool
    _, _, state = to_port(jcfg, jfluid, js)
    rc = RenderConfig(camera=Camera(64, 32), mode="legacy_quad")
    with pytest.raises(ValueError, match="num_particles"):
        render_frame_buckets(state, VIEW, rc)
    img = render_frame_buckets(state, VIEW, rc, num_particles=int((state.mass > 0).sum()))
    assert img.shape == (32, 64, 3) and bool(torch.isfinite(img).all())
    for mode in ("velocity_spheres", "lit_spheres", "depth_debug"):
        rc = RenderConfig(camera=Camera(64, 32), mode=mode)
        img = render_frame_buckets(state, VIEW, rc)
        assert img.shape == (32, 64, 3) and bool(torch.isfinite(img).all())
        assert not torch.equal(img, background_for_view(rc, VIEW, "cpu")[0]), mode
    rc = RenderConfig(camera=Camera(64, 32), mode="none")
    assert torch.equal(render_frame_buckets(state, VIEW, rc),
                       background_for_view(rc, VIEW, "cpu")[0])
    cells = extract_cell_splats(state, VIEW, rc.camera)
    assert cells.shape == (5, jcfg.num_cells)


def test_render_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """Without a card `render` runs only under --device cpu --mode
    bucketed, and writes one readable PNG a frame at the asked size."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["render", "fluid_3d_cpu", "--frames", "1", "--substeps", "1",
            "--width", "128", "--height", "72"]
    with pytest.raises(SystemExit, match="no CUDA device visible"):
        main(base + ["--out", str(tmp_path / "x")])
    for window in ("off", "auto"):
        out = tmp_path / window
        main(base + ["--device", "cpu", "--mode", "bucketed", "--window", window,
                     "--out", str(out)])
        pngs = sorted(out.glob("*.png"))
        assert [p.name for p in pngs] == ["frame_00000.png"]
        img = image.read_png_rgb(str(pngs[-1]))
        assert img.shape == (72, 128, 3) and img.max() > 0
    text = capsys.readouterr().out
    assert "particle-steps/s with render on cpu" in text
    assert any(line.startswith("lost: 0 ") for line in text.splitlines())
    assert "kernel launches: p2g_update=0" in text


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    image.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image.read_png_rgb(str(tmp_path / "a.png")), img)
    f = rng.uniform(0, 1.5, (4, 5, 3)).astype(np.float32)
    image.write_png(str(tmp_path / "b.png"), f)
    np.testing.assert_array_equal(image.read_png_rgb(str(tmp_path / "b.png")),
                                  image.to_uint8(f))
    np.testing.assert_array_equal(
        frame_to_u8(torch.from_numpy(f)).numpy().astype(int), image.to_uint8(f).astype(int))
