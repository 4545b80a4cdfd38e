"""The render path's kernels against the JAX package on the CPU, where each
wrapper takes its plain PyTorch version: kernel X (extract), kernel F's
splat emission, kernel BL (blur) and kernel SH's plain path and
constants (shade). Inputs come from the JAX package (a
scene of tests/test_fused.py, or numpy with a seed) and reach the port
through convert.py. Each test states its bar."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.pallas import fused as jfused
from mpm_tpu.render import Camera as JCamera
from mpm_tpu.render import default_view as jdefault_view
from mpm_tpu.render.blur_kernel import blur_depth_pallas
from mpm_tpu.render.extract_kernel import extract_cell_splats as jextract
from mpm_tpu.render.splat import BG_DEPTH as JBG_DEPTH
from mpm_tpu.render.ssfr import SSFRParams as JSSFRParams
from mpm_tpu.render.ssfr import bilateral_blur_1d
from mpm_tpu_torch import convert
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.render import Camera
from mpm_tpu_torch.render import blur_kernel as kb
from mpm_tpu_torch.render import extract_kernel as kx
from mpm_tpu_torch.render import shade_kernel as ksh
from mpm_tpu_torch.render.splat import BG_DEPTH
from torch_shade_cases import SHADE_CASES, shade_case

torch.set_num_threads(2)

STATE_FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred",
                "ceiling")
CAM = (160, 96)


def to_port(jcfg, jfluid, jstate):
    """The JAX package's config, fluid and bucket state as the port's."""
    cfg = convert.config_from_fields(
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    fluid = convert.fluid_from_numpy(
        {f.name: np.asarray(getattr(jfluid, f.name)) for f in dataclasses.fields(jfluid)})
    state = convert.bucket_state_from_numpy(
        *(np.asarray(getattr(jstate, f)) for f in STATE_FIELDS), device="cpu")
    return cfg, fluid, state


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def stepped(request):
    """fluid_3d at 16^3, K=8, after two JAX substeps (vel non-zero)."""
    sc = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    jcfg = sc.config.replace(bin_capacity=8, storage_dtype=request.param)
    js = jax.jit(lambda s: jb.from_simstate(s, jcfg))(sc.state)
    step = jax.jit(lambda s: jb.substep(s, jcfg, sc.fluid))
    for _ in range(2):
        js = step(js)
    return jcfg, sc.fluid, js, step


def _views():
    jview = jnp.asarray(jdefault_view((16, 16, 16)))
    return np.asarray(jview), jview, Camera(*CAM), JCamera(*CAM)


def _assert_splats_close(got: torch.Tensor, want: np.ndarray):
    """tests/test_render.py:370's bar (rtol 1e-6, atol 1e-5) on every row;
    the valid counts and the empty cells exactly."""
    got = got.numpy()
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[2] >= kx.CELL_BG, want[2] >= kx.CELL_BG)
    assert (want[2] < kx.CELL_BG).sum() > 50
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_render_scals_match_jax():
    view, jview, cam, jcam = _views()
    np.testing.assert_array_equal(kx.render_scals_for(view, cam).numpy(),
                                  np.asarray(jfused.render_scals_for(jview, jcam)))
    assert kx.CELL_BG == jfused._CELL_BG


def test_extract_matches_jax(stepped):
    jcfg, jfluid, js, _ = stepped
    _, _, state = to_port(jcfg, jfluid, js)
    view, jview, cam, jcam = _views()
    n0 = kx.launches
    got = kx.extract_cell_splats(state, view, cam)
    assert kx.launches == n0  # the CPU takes the plain version
    assert torch.equal(got, kx.extract_cell_splats_plain(state, view, cam))
    _assert_splats_close(got, np.asarray(jextract(js, jview, jcam, interpret=True)))


def test_emission_matches_jax(stepped):
    """g2p_migrate(emit_splats=True) against the extraction of the JAX
    bucket engine's next state (not the interpret-mode fused kernel; see
    ROADMAP.md); the state at the JAX package's f32 bars."""
    jcfg, jfluid, js, step = stepped
    cfg, fluid, state = to_port(jcfg, jfluid, js)
    view, jview, cam, jcam = _views()
    rs = kx.render_scals_for(view, cam)
    grid = kp.p2g_update(state, cfg, fluid)
    n0 = kf.launches
    got, splats = kf.g2p_migrate(state, grid, cfg, fluid, emit_splats=True, render_scals=rs)
    assert kf.launches == n0
    js2 = step(js)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(js2.ids))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(js2.pos), atol=1e-6)
    _assert_splats_close(splats, np.asarray(jextract(js2, jview, jcam, interpret=True)))
    # the substep entry gives the same pair, and the splats are the
    # extraction of the state it returns
    got2, splats2 = cuda_step.substep_emit(state, cfg, fluid, (), rs)
    assert torch.equal(got2.pos, got.pos) and torch.equal(splats2, splats)
    assert torch.equal(splats, kx.extract_cell_splats_plain(got, view, cam))
    with pytest.raises(ValueError, match="render_scals"):
        kf.g2p_migrate(state, grid, cfg, fluid, emit_splats=True)


def _blob(h, w, seed, near):
    """A noisy fluid blob, a near patch and a hole, as
    tests/test_render.py:212-278 builds them."""
    rng = np.random.default_rng(seed)
    depth = np.full((h, w), JBG_DEPTH, np.float32)
    if h == 64:
        depth[10:50, 40:200] = 30.0 + rng.uniform(-2, 2, (40, 160)).astype(np.float32)
        depth[20:25, 90:110] = near
    else:
        depth[100:180, 30:220] = 25.0 + rng.uniform(-2, 2, (80, 190)).astype(np.float32)
        depth[150:160, 200:250] = near
    depth[30:33, 60:64] = JBG_DEPTH
    return depth


@pytest.mark.parametrize("h,w,seed", [(64, 256, 7), (320, 512, 11)], ids=["single", "tiled"])
def test_blur_matches_jax(h, w, seed):
    """Radius 6 (the caps of tests/test_render.py:212-278): the port's blur
    against the Pallas kernel in interpret mode and against the XLA path,
    atol 2e-4 rtol 1e-5."""
    depth = _blob(h, w, seed, 12.0 if h == 64 else 10.0)
    cam, jcam = Camera(width=w, height=h), JCamera(width=w, height=h)
    r = 6
    kw = dict(radius=r, max_filter=r, blur_filter_size=7.0, depth_threshold=10.0)
    n0 = kb.launches
    got = kb.blur_depth_kernel(torch.from_numpy(depth), cam, **kw).numpy()
    assert kb.launches == n0
    want = np.asarray(blur_depth_pallas(jnp.asarray(depth), jcam, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)
    params = JSSFRParams(blur_tap_radius=r, max_filter_size=r)
    xla = bilateral_blur_1d(bilateral_blur_1d(jnp.asarray(depth), 1, params, jcam), 0,
                            params, jcam)
    np.testing.assert_allclose(got, np.asarray(xla), atol=2e-4, rtol=1e-5)


def test_blur_radius_100_matches_pallas():
    """The port's one semantics, radius max_filter_size = 100: a near patch
    at depth 0.25 drives the filter to 100 taps a side, against the Pallas
    kernel (interpret mode) at the same radius; atol 2e-4 rtol 1e-5."""
    depth = _blob(64, 256, 7, 0.25)
    cam, jcam = Camera(width=256, height=64), JCamera(width=256, height=64)
    kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
    d = torch.from_numpy(depth)
    assert int(kb.filter_sizes(d, 100, 100, kb.proj_const_for(cam, 7.0)).max()) == 100
    got = kb.blur_depth_kernel(d, cam, **kw).numpy()
    want = np.asarray(blur_depth_pallas(jnp.asarray(depth), jcam, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)
    assert float(np.abs(got - depth).max()) > 1.0  # the blur did something
    assert BG_DEPTH == JBG_DEPTH and kb.BG_DEPTH == BG_DEPTH


def test_render_scals_built_once_per_view():
    """The 16 render scalars of a view tensor and camera are built once: the
    same tensor comes back while the view is unchanged (no copy from a card
    view a call), new values after the view changes in place or for another
    camera; the C entry points take them as a host pointer."""
    from mpm_tpu_torch.ops.cuda.extract_cells import render_scals_for, scals_arg

    nview, jview, cam, jcam = _views()
    view = torch.from_numpy(nview.copy())
    first = render_scals_for(view, cam)
    assert render_scals_for(view, cam) is first
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfused.render_scals_for(jview, jcam)))
    other = render_scals_for(view, dataclasses.replace(cam, width=2 * cam.width))
    assert other is not first and float(other[13]) == float(cam.width)
    view[0, 3] += 1.0
    moved = render_scals_for(view, cam)
    assert moved is not first and float(moved[3]) == float(first[3]) + 1.0
    assert render_scals_for(view.numpy(), cam).tolist() == moved.tolist()
    assert scals_arg(moved).value == moved.data_ptr()
    with pytest.raises(ValueError, match="16 contiguous float32"):
        scals_arg(moved[:8])


def test_blur_work_counts_exponentials():
    """Kernel BL's bound counts each tap's exponential once more over the
    special-function units' rate (132 SMs x 16 a clock x 1.98 GHz), which
    bounds it where the taps are many."""
    from mpm_tpu_torch.utils import roofline

    fx = torch.tensor([[0.0, 100.0], [5.0, 0.0]])
    fy = torch.tensor([[0.0, 100.0], [3.0, 0.0]])
    nbytes, ops, exps = roofline.blur_work(fx, fy)
    assert nbytes == 2 * 4 * 4
    assert exps == 2 * (105 + 103)
    assert ops == 11 * 4 + 9 * exps
    ms, by = roofline.bound_ms(nbytes, ops, exps)
    assert by == "operations"
    assert ms == pytest.approx(exps / (132 * 16 * 1.98e9) * 1e3)
    assert ms > ops / 67e12 * 1e3


@pytest.mark.parametrize("case", SHADE_CASES)
def test_shade_kernel_on_cpu_is_plain(case):
    """Kernel SH's wrapper on CPU buffers: the plain shade, bit for bit, its
    crop composited over the background as the pipeline did before the
    kernel; no launch."""
    from mpm_tpu_torch.render import ssfr
    from mpm_tpu_torch.render.background import make_cubemap_sampler
    from mpm_tpu_torch.render.camera import as_view

    k = shade_case(case, "cpu", full_size=False)
    n0 = ksh.launches
    got, live = ksh.shade_kernel(**k)
    assert ksh.launches == n0 == 0
    color, want_live = ssfr.shade(k["fluid_depth"], k["bg_color"], k["bg_depth"],
                                  make_cubemap_sampler(k["cubemap_faces"]),
                                  as_view(k["view"])[:3, :3], k["params"], k["cam"],
                                  thickness=k["thickness"], crop=k["crop"])
    want = color
    if k["crop"] is not None:
        y0, x0, ch, cw = k["crop"]
        want = k["bg_color"].clone()
        want[y0:y0 + ch, x0:x0 + cw] = color
    assert torch.equal(live, want_live) and 0 < int(live.sum())
    assert torch.equal(got, want)


def test_shade_args_built_once_per_view():
    """Kernel SH's constants are built once for each view, camera,
    parameters and crop: an unchanged view gets the same arguments back; a
    view rotated in place, another crop or other parameters build anew."""
    k = shade_case("crop", "cpu", full_size=False)
    view, cam, params, crop = k["view"].clone(), k["cam"], k["params"], k["crop"]
    shape = tuple(k["fluid_depth"].shape)
    first = ksh.shade_args(view, cam, params, crop, shape)
    assert ksh.shade_args(view, cam, params, crop, shape) is first
    assert ksh.shade_args(view, cam, params, None, (cam.height, cam.width)) is not first
    other = ksh.shade_args(view, cam, dataclasses.replace(params, specular_power=100.0), crop,
                           shape)
    assert other is not first and other.spec_power == 100.0
    view[:3, :3] = view[:3, :3].flip(0)
    moved = ksh.shade_args(view, cam, params, crop, shape)
    assert moved is not first
    assert list(moved.rot) == view[:3, :3].reshape(-1).tolist() != list(first.rot)
    assert ksh.shade_args(view, cam, params, crop, shape) is moved


@pytest.mark.parametrize("light_dir", [(0.0, -1.0, 0.0), (0.0, 0.0, -2.0)])
def test_shade_args_match_the_plain_constants(light_dir):
    """Kernel SH's constants equal, bit for bit, what the plain shade
    computes from them on the CPU: the light in view space, the focal
    length, the pixel centres' offsets, the absorption of Beer's law and
    the sky's sun direction."""
    from mpm_tpu_torch.render import background
    from mpm_tpu_torch.render.camera import as_view, norm3

    k = shade_case("crop", "cpu", full_size=False)
    params = dataclasses.replace(k["params"], light_dir=light_dir)
    cam, crop = k["cam"], k["crop"]
    a = ksh.shade_args(k["view"], cam, params, crop, (crop[2], crop[3]))
    rot = as_view(k["view"])[:3, :3]
    lv = rot @ torch.tensor(params.light_dir, dtype=torch.float32)
    lv = -lv / torch.clamp_min(norm3(lv), 1e-9)
    assert list(a.light) == lv.tolist()
    assert list(a.rot) == rot.reshape(-1).tolist()
    assert a.focal == float(torch.tensor(cam.focal_px, dtype=torch.float32))
    assert (a.ox, a.oy, a.half_w, a.half_h) == (0.5 + crop[1], 0.5 + crop[0], 80.0, 48.0)
    diffuse = torch.tensor(np.asarray(params.diffuse_color, np.float32))
    assert list(a.absorb) == (-params.optical_density * (1.0 - diffuse)).tolist()
    assert list(a.sun_dir) == background.SUN_DIR.tolist()
    assert (a.fh, a.fw, a.y0, a.x0, a.h, a.w, a.ds, a.faces) == (96, 160, *crop, 1, 0)


def test_shade_work_counts_the_frame():
    """Kernel SH's bound: the frame's colour in and out once, 9 bytes a
    buffer pixel (13 with a thickness map), SHADE_OPS and SHADE_SFU a live
    pixel; bound by bytes at the benchmark's frame."""
    from mpm_tpu_torch.utils import roofline

    live = torch.zeros(992, 1024, dtype=torch.bool)
    live[100:900, 100:900] = True
    bg = torch.zeros(1080, 1920, 3)
    nbytes, ops, sfu = roofline.shade_work(live, bg)
    assert nbytes == 2 * 12 * 1080 * 1920 + 9 * 992 * 1024
    assert roofline.shade_work(live, bg, thickness=True)[0] == nbytes + 4 * 992 * 1024
    assert (ops, sfu) == (640_000 * roofline.SHADE_OPS, 640_000 * roofline.SHADE_SFU)
    assert roofline.bound_ms(nbytes, ops, sfu)[1] == "bytes"
