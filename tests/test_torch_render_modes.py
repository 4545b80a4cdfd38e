"""The port's render modes and their functions (mpm_tpu_torch.render) against
the JAX package's on the CPU: the velocity key, the dilation that tracks the
winner's velocity and sphere offsets (with the tie rule of the JAX loop),
the debug composites, the lit spheres, the cubemap sampler and loader, the NDC helpers, and whole frames of every
mode (the thickness pass, the particle-array splat, the sharded composites
and the CLI's new flags: tests/test_torch_thickness.py).

Bars: mins, keys and the dilation's attributes bit for bit (the JAX half
without FMA, tests/torch_render_ref.py, at its focal length of 64); the
other functions bit for bit where XLA computes as the JAX source writes,
else within the ulps stated at each test (XLA multiplies by the reciprocal
of a constant divisor); whole frames by tests/test_torch_render.py's
MAX_OFF_SHARE. Frames and dilations run at splat radius 3: XLA compiles the
radius-6 velocity and lit loops in 12-15 s each."""

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
from mpm_tpu.render import ssfr as jssfr
from mpm_tpu.render.extract_kernel import extract_cell_splats as jextract
from mpm_tpu_torch.render import (Camera, RenderConfig, SSFRParams, background_for_view,
                                  frame_to_u8, render_frame, render_frame_buckets,
                                  render_frame_cells)
from mpm_tpu_torch.render import background, camera, image, splat, ssfr
from test_torch_render import MAX_OFF_SHARE
from test_torch_render_kernels import to_port
from torch_dilate_cases import tie_cells
from torch_render_ref import CAMERA, xla_render

torch.set_num_threads(2)

R = 3  # splat radius of the dilations and frames here
W, H = 128, 96
VIEW = jcamera.look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0))
MODES = [("velocity_spheres", {}), ("lit_spheres", {}), ("depth_debug", {}),
         ("default", {"thickness_pass": True, "thickness_scale": 0.3})]


def _cells(rng, w, h, m=3000):
    """Seeded splat points [5, m] over a w x h frame, a fifth of them empty."""
    c = np.stack([rng.uniform(-5, w + 5, m), rng.uniform(-5, h + 5, m), rng.uniform(20, 60, m),
                  rng.uniform(0, 80, m), rng.integers(1, 9, m)]).astype(np.float32)
    c[2, rng.random(m) < 0.2] = 1e9
    return c


def _zbuf(cells, cam):
    c = torch.tensor(cells)
    return splat.zbuffer_cells(c, cam), splat.velocity_key(c, cam)


@pytest.fixture(scope="module")
def dilation_ref():
    """The port's z-buffers and keys of the random and the tie case, and the
    JAX dilation of each without FMA (one subprocess)."""
    cam = Camera(**CAMERA)
    cases = {"rand": _zbuf(_cells(np.random.default_rng(0), cam.width, cam.height), cam),
             "tie": _zbuf(tie_cells(), cam)}
    t = splat.thickness_deposit(torch.tensor(_cells(np.random.default_rng(1), W, H)), Camera(W, H))
    inputs = {"R": np.int32(R), "t": t.numpy()}
    for name, (d, k) in cases.items():
        inputs[f"{name}.d"], inputs[f"{name}.k"] = d.numpy(), k.numpy()
    return cam, cases, t, xla_render(inputs)


@pytest.fixture(scope="module")
def lattice_cells():
    """tests/test_thickness.py's 16^3 lattice at 128 x 96: the JAX package's
    cell splats (its extraction kernel in interpret mode, once) and the
    port's bucket state."""
    pos = box_lattice((16, 16, 16), (10.0, 6.0, 10.0), 0.8, center=(8.0, 6.0, 8.0))
    jcfg = JSimConfig(grid_res=(16, 16, 16), num_particles=pos.shape[0], substeps=2,
                      bin_capacity=8)
    js = jax.jit(lambda s: jb.from_simstate(s, jcfg))(jmake_state(pos))
    cells = np.asarray(jextract(js, jnp.asarray(VIEW), JCamera(W, H), interpret=True))
    return cells, to_port(jcfg, JFluidParams.create(dim=3), js)[2]


def _rcs(mode, **ssfr_kw):
    """Port and JAX RenderConfigs of `mode` at 128 x 96, radius R, blur cap 12."""
    return (RenderConfig(camera=Camera(W, H), mode=mode, max_radius_px=R,
                         ssfr=SSFRParams(max_filter_size=12, **ssfr_kw)),
            JRenderConfig(camera=JCamera(W, H), mode=mode, max_radius_px=R,
                          ssfr=JSSFRParams(max_filter_size=12, blur_tap_radius=12, **ssfr_kw)))


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps between two arrays of one sign each."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def test_velocity_key_and_zbuffer_bit_equal():
    rng = np.random.default_rng(2)
    cells = _cells(rng, W, H)
    cam, jcam = Camera(W, H), JCamera(W, H)
    for crop in (None, (10, 20, 60, 80)):
        d, k = splat.zbuffer_cells(torch.tensor(cells), cam, crop), \
            splat.velocity_key(torch.tensor(cells), cam, crop)
        jd, jk = jax.jit(lambda c, crop=crop: jsplat.zbuffer_cells(c, jcam, crop=crop))(cells)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        assert k.dtype == torch.int32 and int((k != splat.KEY_EMPTY).sum()) > 500


@pytest.mark.parametrize("case", ["rand", "tie"])
def test_dilation_tracking_bit_equal(dilation_ref, case):
    """buffers_from_zbuffer(with_normals=True) with the velocity key: depth,
    velocity, sx and sy bit for bit; the depth also equals the untracked
    dilation's. On the tie case the first tap of the JAX loop's order (dy,
    then dx, ascending) wins: the right source of the row pair, the lower
    of the column pair, the lower right corner."""
    cam, cases, _, ref = dilation_ref
    d, k = cases[case]
    got = splat.buffers_from_zbuffer(d, cam, 1.0, R, key=k, with_normals=True)
    for f in ("depth", "velocity", "sx", "sy"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f"{case}.{f}"], err_msg=f)
    assert torch.equal(got.depth, splat.buffers_from_zbuffer(d, cam, 1.0, R).depth)
    if case == "tie":
        v = got.velocity
        assert (float(v[20, 32]), float(v[52, 60]), float(v[80, 80])) == (2.0, 4.0, 8.0)
        assert float(got.sx[20, 32]) < 0 and float(got.sy[52, 60]) < 0
        assert float(got.depth[20, 32]) < 20.0  # an offer of the pair's discs


def test_gaussian_blur_and_thickness_map_bit_equal(dilation_ref):
    """Normalised, tap by tap in the JAX order: bit for bit without FMA; the
    blur keeps the total of deposits at least its radius from the edges
    (rtol 1e-5)."""
    _, _, t, ref = dilation_ref
    inner = torch.zeros_like(t)
    inner[6:-6, 6:-6] = t[6:-6, 6:-6]
    for radius in (1, 6):
        g = ssfr.gaussian_blur(t, radius)
        np.testing.assert_array_equal(g.numpy(), ref[f"blur{radius}"])
        np.testing.assert_allclose(float(ssfr.gaussian_blur(inner, radius).double().sum()),
                                   float(inner.double().sum()), rtol=1e-5)
    assert ssfr.gaussian_blur(t, 0) is t
    p = SSFRParams()
    np.testing.assert_array_equal(ssfr.thickness_map(t, p).numpy(), np.maximum(
        np.float32(p.thickness), np.float32(p.thickness_scale) * ref["blur6"]))


def test_debug_composites_match_jax():
    """depth_debug_image within 1 ulp (XLA multiplies by 1/100); the
    threshold and velocity-sphere composites bit for bit."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.0, 5000.0, (H, W)).astype(np.float32)
    got = ssfr.depth_debug_image(torch.tensor(depth), SSFRParams()).numpy()
    want = np.asarray(jax.jit(lambda x: jssfr.depth_debug_image(x, JSSFRParams()))(depth))
    assert got.shape == (H, W, 3) and _ulps(got, want) <= 1
    assert (got == 1.0).any() and (got < 1.0).any()
    dst, src = (rng.uniform(0, 0.02, (H, W, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        ssfr.composite_threshold(torch.tensor(dst), torch.tensor(src)).numpy(),
        np.asarray(jax.jit(jssfr.composite_threshold)(dst, src)))
    bgd = rng.uniform(10, 80, (H, W)).astype(np.float32)
    fcol = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ssfr.velocity_spheres_composite(torch.tensor(dst), torch.tensor(bgd),
                                        torch.tensor(depth / 60), torch.tensor(fcol)).numpy(),
        np.asarray(jax.jit(jssfr.velocity_spheres_composite)(dst, bgd, depth / 60, fcol)))


def test_lit_spheres_shade_matches_jax():
    """Within 4e-7 (XLA multiplies by 1/pi and contracts the Rodrigues
    products to FMA)."""
    cam, jcam = Camera(W, H), JCamera(W, H)
    d, k = _zbuf(_cells(np.random.default_rng(4), W, H), cam)
    bufs = splat.buffers_from_zbuffer(d, cam, 1.0, R, key=k, with_normals=True)
    bgc, bgd = background.render_background(cam, VIEW, device="cpu")
    got = ssfr.lit_spheres_shade(bufs, bgc, bgd, torch.tensor(VIEW)[:3, :3], SSFRParams(), cam)
    jbufs = jsplat.SplatBuffers(*(jnp.asarray(getattr(bufs, f).numpy())
                                  for f in ("depth", "velocity", "sx", "sy")))
    want = jax.jit(lambda b, c, dd: jssfr.lit_spheres_shade(
        b, c, dd, jnp.asarray(VIEW)[:3, :3], JSSFRParams(), jcam))(jbufs, bgc.numpy(), bgd.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=4e-7)
    assert int((bufs.depth < splat.BG_DEPTH).sum()) > 1000


def test_cubemap_sampler_and_loader(tmp_path):
    """The sampler bit for bit on seeded faces and directions; the loader
    reads both namings as the JAX package does, and refuses a directory
    without six faces."""
    rng = np.random.default_rng(7)
    faces = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 40, 3)).astype(np.float32)
    got = background.make_cubemap_sampler(torch.tensor(faces))(torch.tensor(dirs))
    want = jax.jit(lambda x: jbackground.make_cubemap_sampler(jnp.asarray(faces))(x))(dirs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u8 = rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    for names in ([f"sky-{i}" for i in range(1, 7)], ["px", "nx", "py", "ny", "pz", "nz"]):
        d = tmp_path / names[0]
        d.mkdir()
        for face, name in zip(u8, names):
            image.write_png(str(d / f"{name}.png"), face)
        got = background.load_cubemap(str(d), device="cpu")
        assert got.shape == (6, 16, 16, 3) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbackground.load_cubemap(str(d))))
    with pytest.raises(FileNotFoundError, match="6-face cubemap"):
        background.load_cubemap(str(tmp_path), device="cpu")


def test_ndc_depth_pair_matches_jax():
    """Within 2 ulps (XLA contracts d * a + b to an FMA); the pair inverts."""
    rng = np.random.default_rng(8)
    ndc = rng.uniform(1e-4, 1.0, 4096).astype(np.float32)
    cam, jcam = Camera(), JCamera()
    lin = camera.ndc_depth_to_linear(torch.tensor(ndc), cam)
    assert _ulps(lin.numpy(), jax.jit(lambda x: jcamera.ndc_depth_to_linear(x, jcam))(ndc)) <= 2
    back = camera.linear_depth_to_ndc(lin, cam)
    assert _ulps(back.numpy(), jax.jit(lambda x: jcamera.linear_depth_to_ndc(x, jcam))(
        lin.numpy())) <= 2
    np.testing.assert_allclose(back.numpy(), ndc, rtol=1e-4)


@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_mode_frame_matches_jax(lattice_cells, mode, kw):
    """render_frame_cells of each mode from the JAX package's cell splats,
    against its render_frame_cells, by MAX_OFF_SHARE; fluid on more than 1%
    of the frame (at most 20% for the depth view, which greys the
    background too); the thickness frame differs from the constant one."""
    cells, _ = lattice_cells
    rc, jrc = _rcs(mode, **kw)
    bg = background_for_view(rc, VIEW, "cpu")
    img = frame_to_u8(render_frame_cells(torch.tensor(cells), VIEW, rc, bg=bg))
    jimg = jax.jit(lambda c, v: jpipeline.frame_to_u8(jpipeline.render_frame_cells(c, v, jrc)))(
        cells, VIEW)
    d = np.abs(img.numpy().astype(np.int32) - np.asarray(jimg).astype(np.int32))
    share = float((d.max(axis=-1) > 1).mean())
    print(f"{mode}: {share:.5f} of pixels off by more than 1 LSB")
    assert share <= MAX_OFF_SHARE
    fluid = float(((img.int() - frame_to_u8(bg[0]).int()).abs().amax(-1) > 2).float().mean())
    assert fluid > 0.01
    if kw.get("thickness_pass"):
        const = frame_to_u8(render_frame_cells(torch.tensor(cells), VIEW, _rcs(mode)[0], bg=bg))
        assert float((img.int() - const.int()).abs().float().mean()) > 0.1


def test_modes_render_from_buckets(lattice_cells):
    """Every mode through render_frame_buckets (the port's own cell
    extraction) and through render_frame on the live slots: a frame of
    fluid over the background; debug_draw_depth draws the depth view."""
    _, state = lattice_cells
    live = state.mass.reshape(-1) > 0
    pos = state.pos.reshape(3, -1)[:, live]
    vmag = torch.linalg.vector_norm(state.vel.reshape(3, -1)[:, live].float(), dim=0)
    for mode, kw in MODES:
        rc = _rcs(mode, **kw)[0]
        bg = background_for_view(rc, VIEW, "cpu")
        for img in (render_frame_buckets(state, VIEW, rc, bg=bg),
                    render_frame(pos, vmag, VIEW, rc, bg=bg)):
            assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            assert float(((img - bg[0]).abs().amax(-1) > 0.01).float().mean()) > 0.01, mode
    rc = _rcs("default", debug_draw_depth=True)[0]
    assert torch.equal(render_frame_buckets(state, VIEW, rc),
                       render_frame_buckets(state, VIEW, _rcs("depth_debug")[0]))
