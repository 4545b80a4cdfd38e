"""Kernels P, F, X and BL against their plain PyTorch versions on a CUDA
card, at the small scene of tests/test_fused.py. Every test needs the card and skips
without one. They import no JAX, so on a machine without JAX run them with

    python -m pytest --noconftest tests/test_torch_cuda.py

Bars: the JAX package's own (tests/test_fused.py). The kernels repeat the
plain version's arithmetic operation for operation; kernel P differs from
it in the last bit where nvcc fuses a multiply and an add, and kernel F,
built without fusing, agrees with it bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from mpm_tpu_torch.models.scenes import fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import window_config

pytestmark = pytest.mark.requires_cuda

GOLDEN_3D = os.path.join(os.path.dirname(__file__), "golden",
                         "fluid_3d_small_bucketed.npz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(dev, storage="float32", grid_res=None, **kw):
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=dev)
    config = sc.config.replace(bin_capacity=8, storage_dtype=storage, **kw)
    if grid_res is not None:
        config = window_config(config.replace(grid_res=grid_res), 16)
    return config, sc.fluid, bucketed.from_simstate(sc.state, config)


def _warm(state, config, fluid, n=2):
    """A few plain substeps so vel and C are non-zero."""
    for _ in range(n):
        state = bucketed.substep(state, config, fluid)
    return state


def _assert_states_close(a, b, bf16):
    np.testing.assert_array_equal(a.ids.cpu().numpy(), b.ids.cpu().numpy())
    np.testing.assert_allclose(a.pos.cpu().numpy(), b.pos.cpu().numpy(), atol=1e-6)
    for x, y in ((a.vel, b.vel), (a.C, b.C)):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        if bf16:
            np.testing.assert_allclose(x, y, rtol=0.01, atol=1e-4)
        else:
            np.testing.assert_allclose(x, y, atol=1e-5)
    for name in ("lost", "cfl_clamped", "deferred", "ceiling"):
        assert int(getattr(a, name)) == int(getattr(b, name)), name


P_CASES = {
    "float32": {},
    "bfloat16": dict(storage="bfloat16"),
    "eos_power_static": dict(eos_power_static=7.0),
    "friction": dict(bc="friction", bc_band_hi=3),
    "stick": dict(bc="stick"),
    "legacy_strain": dict(legacy_strain=True),
}


@pytest.mark.parametrize("case", list(P_CASES))
def test_kernel_p_matches_plain(dev, case):
    config, fluid, state = _scene(dev, **P_CASES[case])
    state = _warm(state, config, fluid)
    n0 = kp.launches
    got = kp.p2g_update(state, config, fluid)
    torch.cuda.synchronize()
    assert kp.launches == n0 + 1
    want = kp.p2g_update_plain(state, config, fluid)
    scale = float(want.mom.abs().max())
    assert scale > 0
    torch.testing.assert_close(got.mom, want.mom, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(got.mass, want.mass, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "windowed", "interactions"])
def test_kernel_f_matches_plain(dev, case):
    storage = "bfloat16" if case == "bfloat16" else "float32"
    config, fluid, state = _scene(
        dev, storage, grid_res=(16, 32, 16) if case == "windowed" else None)
    inter = (Interaction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),
             Interaction.mouse((6.0, 7.0, 8.0), radius=3.0, strength=0.2)) \
        if case == "interactions" else ()
    state = _warm(state, config, fluid)
    grid = kp.p2g_update_plain(state, config, fluid)
    n0 = kf.launches
    got = kf.g2p_migrate(state, grid, config, fluid, inter)
    torch.cuda.synchronize()
    assert kf.launches == n0 + 1
    want = kf.g2p_migrate_plain(state, grid, config, fluid, inter)
    _assert_states_close(got, want, storage == "bfloat16")


def test_ceiling_band_matches_plain(dev):
    """Particles in the last legal row of a window, moving up fast: the
    kernel's ceiling rejection counts and clamps as the plain version's."""
    from mpm_tpu_torch.core.params import FluidParams, SimConfig
    from mpm_tpu_torch.core.state import make_state

    wcfg = window_config(SimConfig(grid_res=(16, 32, 16), substeps=2,
                                   bin_capacity=8), 16)
    pos = np.stack(np.meshgrid(np.arange(5, 11) + 0.5, [12.9],
                               np.arange(5, 11) + 0.5, indexing="ij"),
                   -1).reshape(-1, 3)
    st = make_state(pos.astype(np.float32), dev)
    st.vel[1] = 5.0
    fluid = FluidParams.create(dim=3, gravity=0.0)
    b = bucketed.from_simstate(st, wcfg)
    got = make_step(wcfg, mode="cuda", substeps=3)(b, fluid)
    want = make_step(wcfg, mode="bucketed", substeps=3)(b, fluid)
    assert int(got.ceiling) > 0
    _assert_states_close(got, want, False)


def test_substeps_match_plain(dev):
    config, fluid, state = _scene(dev, "bfloat16")
    got = make_step(config, mode="cuda", substeps=6)(state, fluid)
    want = make_step(config, mode="bucketed", substeps=6)(state, fluid)
    _assert_states_close(got, want, True)
    assert int(got.lost) == 0


def test_golden_anchor(dev):
    """The 3D bucket-engine fixture of tests/test_golden.py replayed through
    the kernels, at the fused engine's bar there (atol 5e-4)."""
    data = np.load(GOLDEN_3D)
    config, fluid, state = _scene(dev)
    step = make_step(config, mode="cuda", substeps=1)
    for i in range(1, 31):
        state = step(state, fluid)
        if i in (10, 30):
            s = bucketed.to_simstate(state)
            np.testing.assert_allclose(s.pos.cpu().numpy(), data[f"pos_s{i}"],
                                       atol=5e-4)
    assert int(state.lost) == 0


def test_unsupported_configs_raise(dev):
    config, fluid, state = _scene(dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kp.p2g_update(state, config.replace(fixed_point=True), fluid)
    grid = kp.p2g_update(state, config, fluid)
    with pytest.raises(ValueError, match="render_scals"):
        kf.g2p_migrate(state, grid, config, fluid, emit_splats=True)


# ---- render kernels: X (extract), F's splat emission, BL (blur) ----------

def _view_cam():
    from mpm_tpu_torch.render import Camera, default_view

    return default_view((16, 16, 16)), Camera(width=160, height=96)


def _assert_splats_equal(got, want):
    """Kernel X's bar: rows 2 (depth) and 4 (count) equal, rows 0, 1 and 3
    within rtol 1e-6 and atol 1e-5 (tests/test_render.py:370). Built
    without fused multiply-adds, the kernel rounds as the plain version
    does, so the rows are expected equal."""
    assert torch.equal(got[2], want[2]) and torch.equal(got[4], want[4])
    for r in (0, 1, 3):
        torch.testing.assert_close(got[r], want[r], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernel_x_matches_plain(dev, storage):
    from mpm_tpu_torch.render import extract_kernel as kx

    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    view, cam = _view_cam()
    n0 = kx.launches
    got = kx.extract_cell_splats(state, view, cam)
    torch.cuda.synchronize()
    assert kx.launches == n0 + 1
    want = kx.extract_cell_splats_plain(state, view, cam)
    assert int((want[2] < kx.CELL_BG).sum()) > 0
    _assert_splats_equal(got, want)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_kernel_f_emission_matches_plain(dev, storage):
    from mpm_tpu_torch.ops.cuda import step as cuda_step
    from mpm_tpu_torch.render import extract_kernel as kx

    config, fluid, state = _scene(dev, storage)
    state = _warm(state, config, fluid)
    view, cam = _view_cam()
    rs = kx.render_scals_for(view, cam)
    n0 = kf.emit_launches
    got, splats = cuda_step.substep_emit(state, config, fluid, (), rs)
    torch.cuda.synchronize()
    assert kf.emit_launches == n0 + 1
    grid = kp.p2g_update(state, config, fluid)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    _assert_states_close(got, want, storage == "bfloat16")
    _assert_splats_equal(splats, kx.cell_splats_plain(got.pos, got.vel, got.mass, rs))
    torch.testing.assert_close(splats, kx.extract_cell_splats(got, view, cam), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(64, 256), (96, 200)])
def test_kernel_bl_matches_plain(dev, shape):
    """A fluid blob with noise, a hole and a near patch at depth 0.25, so
    the filter size reaches its cap of 100 at these heights (bar:
    tests/test_render.py:240)."""
    from mpm_tpu_torch.render import Camera
    from mpm_tpu_torch.render import blur_kernel as kb
    from mpm_tpu_torch.render.splat import BG_DEPTH

    h, w = shape
    rng = np.random.default_rng(7)
    depth = np.full((h, w), BG_DEPTH, np.float32)
    depth[10:50, 40:190] = 30.0 + rng.uniform(-2, 2, (40, 150)).astype(np.float32)
    depth[20:25, 90:110] = 0.25
    depth[30:34, 60:64] = BG_DEPTH
    d = torch.from_numpy(depth).to(dev)
    cam = Camera(width=w, height=h)
    kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
    pc = kb.proj_const_for(cam, 7.0)
    assert int(kb.filter_sizes(d, 100, 100, pc).max()) == 100
    n0 = kb.launches
    got = kb.blur_depth_kernel(d, cam, **kw)
    torch.cuda.synchronize()
    assert kb.launches == n0 + 1
    want = kb.blur_depth_plain(d, cam, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
