"""The render path's kernels against the JAX package on the CPU, where each
wrapper takes its plain PyTorch version: kernel X (extract), kernel F's
splat emission and kernel BL (blur). Inputs come from the JAX package (a
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
from mpm_tpu_torch.render.splat import BG_DEPTH

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
