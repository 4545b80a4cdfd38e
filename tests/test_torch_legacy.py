"""The port's dormant render paths (mpm_tpu_torch.render.legacy, R12/R13)
against the JAX package's (mpm_tpu.render.legacy) on the same inputs, on
the CPU, and `render --render-mode legacy_quad` through the port's CLI.

Bars: the depth packing and the texture contract exactly; the blurs at
tests/test_legacy.py's own tolerances (constant rtol 1e-5, the step 1e-3,
the colour quirk 1e-5) and against the JAX blurs at 1e-5 (the exponentials
of two libraries); the packed splat at tests/test_legacy.py's 2e-6; the
whole frame's fluid mask equal and its grey within 1e-4 of the JAX frame's.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.core.state import make_state as jmake_state
from mpm_tpu.models.emitters import box_lattice
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.render import legacy as jl
from mpm_tpu.render.camera import Camera as JCamera
from mpm_tpu.render.camera import look_at
from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.core.params import SimConfig
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.render import Camera, RenderConfig, legacy, render_frame_buckets
from mpm_tpu_torch.render.image import read_png_rgb

torch.set_num_threads(2)

GRID, BOX, CENTER, SPACING = (16, 16, 16), (8.0, 6.0, 8.0), (8.0, 7.0, 8.0), 0.8
VIEW = look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0))


@pytest.fixture(scope="module")
def scene():
    """tests/test_legacy.py's scene in both packages: (port config, port
    bucket state, JAX bucket state, n)."""
    pos = box_lattice(GRID, BOX, SPACING, center=CENTER)
    n = pos.shape[0]
    jcfg = JConfig(grid_res=GRID, num_particles=n, substeps=2, bin_capacity=8)
    cfg = SimConfig(grid_res=GRID, num_particles=n, substeps=2, bin_capacity=8)
    jbs = jax.jit(lambda s: jb.from_simstate(s, jcfg))(jmake_state(pos))
    bs = bucketed.from_simstate(make_state(np.asarray(pos, np.float32), "cpu"), cfg)
    return cfg, bs, jbs, n


def test_pack_unpack_exact():
    rng = np.random.default_rng(7)
    d = rng.uniform(0.0, 1.0, (64, 64)).astype(np.float32)
    packed = legacy.pack_depth(torch.from_numpy(d))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jl.pack_depth(jnp.asarray(d))))
    np.testing.assert_array_equal(legacy.unpack_depth(packed).numpy(),
                                  np.asarray(jl.unpack_depth(jnp.asarray(packed.numpy()))))
    np.testing.assert_allclose(legacy.unpack_depth(packed).numpy(), d, atol=2e-6)


def test_texture_contract_exact(scene):
    """The texture width, the id-ordered texture of a particle array and of
    a bucket state, and the read back, equal the JAX package's."""
    _, bs, jbs, n = scene
    for m in (1, 4, 37, 157464):
        assert legacy.pos_texture_width(m) == jl.pos_texture_width(m)
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 16, (3, 37)).astype(np.float32)
    vmag = rng.uniform(0, 4, (37,)).astype(np.float32)
    tex = legacy.particle_pos_texture(torch.from_numpy(pos), torch.from_numpy(vmag), 37)
    np.testing.assert_array_equal(tex.numpy(), np.asarray(
        jl.particle_pos_texture(jnp.asarray(pos), jnp.asarray(vmag), 37)))
    p2, v2 = legacy.particles_from_texture(tex, 37)
    np.testing.assert_array_equal(p2.numpy(), pos)
    np.testing.assert_array_equal(v2.numpy(), vmag)
    np.testing.assert_array_equal(legacy.particle_pos_texture_from_state(bs, n).numpy(),
                                  np.asarray(jl.particle_pos_texture_from_state(jbs, n)))


def test_legacy_depth_blur_constant_and_bilateral():
    d = torch.full((24, 32), 37.5)
    np.testing.assert_allclose(legacy.legacy_bilateral_blur_1d(d, (1, 0), filter_size=10).numpy(),
                               37.5, rtol=1e-5)
    step = torch.cat([torch.full((16, 16), 10.0), torch.full((16, 16), 1000.0)], dim=1)
    out = legacy.legacy_bilateral_blur_1d(step, (1, 0), filter_size=8, sigma_range=2.0).numpy()
    np.testing.assert_allclose(out[:, :14], 10.0, atol=1e-3)
    np.testing.assert_allclose(out[:, 18:], 1000.0, atol=1e-3)


@pytest.mark.parametrize("blur_dir", [(1, 0), (0, 1)])
def test_legacy_blurs_match_jax(blur_dir):
    """Both legacy blurs, the colour mode's sample.r quirk included, on a
    seeded depth and colour image (atol 1e-5)."""
    rng = np.random.default_rng(11)
    depth = rng.uniform(5.0, 40.0, (20, 28)).astype(np.float32)
    got = legacy.legacy_bilateral_blur_1d(torch.from_numpy(depth), blur_dir, 6, 2.0)
    want = jl.legacy_bilateral_blur_1d(jnp.asarray(depth), blur_dir, 6, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    img = rng.uniform(0, 1, (8, 24, 3)).astype(np.float32)
    got = legacy.legacy_color_blur_1d(torch.from_numpy(img), blur_dir, 5, 0.3)
    want = jl.legacy_color_blur_1d(jnp.asarray(img), blur_dir, 5, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_legacy_depth_view_matches_jax():
    rng = np.random.default_rng(5)
    ndc = rng.uniform(0.0, 0.2, (12, 16)).astype(np.float32)
    ndc[0, :4] = 0.0
    bg = np.full((12, 16, 3), 0.25, np.float32)
    got = legacy.legacy_depth_view(torch.from_numpy(ndc), Camera(width=16, height=12),
                                   torch.from_numpy(bg))
    want = jl.legacy_depth_view(jnp.asarray(ndc), JCamera(width=16, height=12), jnp.asarray(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_packed_depth_splat_matches_jax(scene):
    """The packed impostor splat: the same pixels drawn, and the unpacked
    depth within 2e-6 of the JAX package's."""
    _, bs, jbs, n = scene
    s = bucketed.to_simstate(bs)
    got = legacy.packed_depth_splat(s.pos, torch.from_numpy(VIEW), Camera(width=128, height=96))
    want = np.asarray(jl.packed_depth_splat(jb.to_simstate(jbs, n).pos, jnp.asarray(VIEW),
                                            JCamera(width=128, height=96)))
    np.testing.assert_array_equal(got.numpy().any(-1), want.any(-1))
    np.testing.assert_allclose(legacy.unpack_depth(got).numpy(),
                               np.asarray(jl.unpack_depth(jnp.asarray(want))), atol=2e-6)


def test_legacy_quad_frame_matches_jax(scene):
    """The whole chain through render_frame_buckets(mode="legacy_quad"):
    fluid pixels grey, the background elsewhere, the fluid mask equal to
    the JAX frame's and the grey within 1e-4; without num_particles it
    raises, as the JAX package's does."""
    _, bs, jbs, n = scene
    cam, jcam = Camera(width=128, height=96), JCamera(width=128, height=96)
    bg = np.broadcast_to(np.asarray([0.8, 0.1, 0.1], np.float32), (96, 128, 3)).copy()
    got = legacy.legacy_quad_frame(bs, n, torch.from_numpy(VIEW), cam, torch.from_numpy(bg))
    want = np.asarray(jl.legacy_quad_frame(jbs, n, jnp.asarray(VIEW), jcam, jnp.asarray(bg)))
    img = got.numpy()
    fluid = ~np.all(img == bg[0, 0], axis=-1)
    assert fluid.any() and not fluid.all()
    np.testing.assert_array_equal(fluid, ~np.all(want == bg[0, 0], axis=-1))
    np.testing.assert_allclose(img[..., 0][fluid], img[..., 2][fluid], atol=1e-6)
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-4)
    rc = RenderConfig(camera=cam, mode="legacy_quad")
    with pytest.raises(ValueError, match="num_particles"):
        render_frame_buckets(bs, VIEW, rc)
    frame = render_frame_buckets(bs, VIEW, rc, num_particles=n)
    assert frame.shape == (96, 128, 3) and bool(torch.isfinite(frame).all())


def test_cli_render_legacy_quad(tmp_path):
    """--render-mode legacy_quad through the port's CLI on the CPU: one
    PNG that differs from a `--render-mode none` frame (the background);
    with --sphere-render-ratio below 1 the CLI refuses, as the JAX one does."""
    base = ["render", "fluid_3d_cpu", "--frames", "1", "--device", "cpu", "--mode",
            "bucketed", "--substeps", "1", "--width", "160", "--height", "90"]
    main([*base, "--out", str(tmp_path / "lq"), "--render-mode", "legacy_quad"])
    main([*base, "--out", str(tmp_path / "bg"), "--render-mode", "none"])
    (lq,) = glob.glob(os.path.join(str(tmp_path / "lq"), "*.png"))
    (bg,) = glob.glob(os.path.join(str(tmp_path / "bg"), "*.png"))
    assert np.abs(read_png_rgb(lq).astype(int) - read_png_rgb(bg).astype(int)).max() > 20
    with pytest.raises(SystemExit, match="texture contract"):
        main([*base, "--out", str(tmp_path / "r"), "--render-mode", "legacy_quad",
              "--sphere-render-ratio", "0.5"])
