"""The 2D path of the port against the JAX package's, on the CPU: the 2D
scenes, the 2D substep (the JAX package's Pallas 2D kernels in interpret
mode once, its XLA bucket engine everywhere else), the mouse, the crush,
the reduced 2D benchmark, the 2D golden anchor, render_2d and the 2D CLI.

Bars: the JAX package's 2D bars (tests/test_kernels2d.py): ids equal slot
for slot, pos atol 1e-6, vel/C atol 1e-5, counters equal; at 128^2, where
pos reaches 125 (one float32 ulp is 7.6e-6), pos atol 1.6e-5 and vel/C
atol 5e-5, because JAX on the CPU fuses multiply-adds.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models import scenes as jscenes
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.interact import Interaction as JInteraction
from mpm_tpu.ops.pallas import kernels2d as jk2d
from mpm_tpu.render.pipeline import frame_to_u8 as jframe_to_u8
from mpm_tpu.render.render2d import render_2d as jrender_2d
from mpm_tpu_torch import convert
from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.core.params import FluidParams
from mpm_tpu_torch.models import scenes as tscenes
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import substep2d as k2d
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.render import bucket_frame_2d, frame_to_u8, render_2d
from mpm_tpu_torch.render.image import read_png_rgb

torch.set_num_threads(2)

GOLDEN_2D = os.path.join(os.path.dirname(__file__), "golden", "dam_break_2d_oracle.npz")
STATE_FIELDS = ("pos", "vel", "C", "mass", "ids")
COUNTERS = ("lost", "cfl_clamped", "deferred")
SCENES_2D = [("dam_break_2d", {}), ("fluid_2d_friction", {}),
             ("bench2d", {"n_target": 20_000, "grid_res": 128})]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def to_port(jcfg, jfluid, jstate):
    """The JAX config, fluid and bucket state carried across (convert.py)."""
    cfg = convert.config_from_fields(_fields(jcfg))
    fluid = convert.fluid_from_numpy({k: np.asarray(v) for k, v in _fields(jfluid).items()})
    state = convert.bucket_state_from_numpy(
        *(np.asarray(getattr(jstate, f)) for f in STATE_FIELDS + COUNTERS + ("ceiling",)),
        device="cpu")
    return cfg, fluid, state


def assert_states_close(got, want, pos_atol=1e-6, vc_atol=1e-5):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=0, atol=pos_atol)
    for f in ("vel", "C"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=vc_atol, err_msg=f)
    for f in COUNTERS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f


@functools.cache
def _jax_substep(config):
    return jax.jit(lambda b, f, it: jb.substep(b, config, f, it))


@pytest.fixture(scope="module")
def dam():
    """dam_break_2d at K=8: the JAX config, fluid and bucket state."""
    sc = jscenes.get_scene("dam_break_2d")
    config = sc.config.replace(bin_capacity=8)
    return config, sc.fluid, jax.jit(lambda s: jb.from_simstate(s, config))(sc.state)


@pytest.mark.parametrize("name,kw", SCENES_2D, ids=[s[0] for s in SCENES_2D])
def test_2d_scene_matches_jax(name, kw):
    j = jscenes.SCENES[name](**kw)
    t = tscenes.get_scene(name, device="cpu", **kw)
    assert t.name == j.name
    assert convert.config_from_fields(_fields(j.config)) == t.config
    for f in dataclasses.fields(FluidParams):
        np.testing.assert_array_equal(np.asarray(getattr(j.fluid, f.name)),
                                      getattr(t.fluid, f.name).numpy(), err_msg=f.name)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j.state, f)),
                                      getattr(t.state, f).numpy(), err_msg=f)


def test_cuda_mode_matches_pallas_2d_kernel(dam):
    """make_step(mode="cuda") on CPU tensors (the 2D wrappers' plain
    versions) against the JAX package's 2D Pallas kernels in interpret
    mode, 4 substeps; the packing of both packages agrees first."""
    jcfg, jfluid, jstate = dam
    cfg, fluid, state = to_port(jcfg, jfluid, jstate)
    packed = tb.from_simstate(tscenes.dam_break_2d(device="cpu").state, cfg)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(packed, f), getattr(state, f)), f
    n0 = (k2d.sim2d_launches, k2d.migrate2d_launches)
    got = make_step(cfg, mode="cuda", substeps=4)(state, fluid)
    assert (k2d.sim2d_launches, k2d.migrate2d_launches) == n0  # no kernel ran
    want = jstate
    for _ in range(4):
        want = jk2d.substep2d(want, jcfg, jfluid, (), interpret=True)
    assert_states_close(got, want)
    assert int(got.lost) == 0


def test_mouse_one_substep_matches_jax(dam):
    jcfg, jfluid, jstate = dam
    cfg, fluid, state = to_port(jcfg, jfluid, jstate)
    jinter = (JInteraction.mouse((32.0, 20.0), radius=10.0, strength=0.5),)
    inter = (Interaction.mouse((32.0, 20.0), radius=10.0, strength=0.5),)
    got = k2d.substep2d(state, cfg, fluid, inter)
    want = _jax_substep(jcfg)(jstate, jfluid, jinter)
    assert_states_close(got, want)
    # the mouse moved particles: the result differs from the free substep
    free = k2d.substep2d(state, cfg, fluid)
    assert not torch.equal(free.vel, got.vel)


def test_crush_matches_jax(dam):
    """tests/test_kernels2d.py's crush: gravity (0, 40) for 30 substeps.
    Overflow rejection defers moves and loses none, in both packages; the
    violent run drifts apart in the last bits, so one more substep from the
    JAX package's crushed state is compared. The crush packs positions
    up to 62 and velocities of tens of cells a substep, so the bars are
    those of the 128^2 benchmark: pos atol 7.6e-6 (2 ulp at 62), vel/C
    atol 5e-5 (JAX's fused multiply-adds; on the CPU the errors reach
    3.8e-6, 9.5e-6 and 2.5e-5 per substep along the crush)."""
    jcfg, jfluid, jstate = dam
    jfluid = jfluid.replace(gravity=jnp.asarray([0.0, 40.0]))
    cfg, fluid, state = to_port(jcfg, jfluid, jstate)
    jstep = _jax_substep(jcfg)
    got, want = state, jstate
    for _ in range(30):
        got = k2d.substep2d(got, cfg, fluid)
        want = jstep(want, jfluid, ())
    for s in (got, to_port(jcfg, jfluid, want)[2]):
        occ = s.mass > 0
        assert int(s.lost) == 0 and int(s.deferred) > 0
        assert int(occ.sum()) == 1024 and int(occ.sum(dim=0).max()) <= cfg.bin_capacity
    crushed = to_port(jcfg, jfluid, want)[2]
    assert_states_close(k2d.substep2d(crushed, cfg, fluid), jstep(want, jfluid, ()),
                        pos_atol=7.6e-6, vc_atol=5e-5)


def test_reduced_bench2d_matches_jax():
    """bench2d at 20k particles on 128^2, K=4: 4 substeps."""
    sc = jscenes.benchmark_scene_2d(n_target=20_000, grid_res=128)
    jstate = jax.jit(lambda s: jb.from_simstate(s, sc.config))(sc.state)
    cfg, fluid, state = to_port(sc.config, sc.fluid, jstate)
    jstep = _jax_substep(sc.config)
    got, want = state, jstate
    for _ in range(4):
        got = k2d.substep2d(got, cfg, fluid)
        want = jstep(want, sc.fluid, ())
    assert_states_close(got, want, pos_atol=1.6e-5, vc_atol=5e-5)
    assert int(got.lost) == 0


def test_golden_anchor_2d():
    """tests/test_golden.py's 2D anchor through the port's plain path:
    K=32, atol 2e-3 at frames 1, 5 and 10, no deferred move."""
    data = np.load(GOLDEN_2D)
    sc = tscenes.dam_break_2d(device="cpu")
    config = sc.config.replace(bin_capacity=32)
    state = tb.from_simstate(sc.state, config)
    step = make_step(config, mode="cuda")
    for frame in range(1, 11):
        state = step(state, sc.fluid)
        if frame in (1, 5, 10):
            np.testing.assert_allclose(tb.to_simstate(state).pos.numpy(),
                                       data[f"pos_f{frame}"], atol=2e-3)
    assert int(state.deferred) == 0 and int(state.lost) == 0


def test_render_2d_matches_jax(dam):
    """render_2d against the JAX package's on one moving state: u8 frames,
    at most 0.1% of pixels off by more than 1 LSB (the mean |v| sums in
    another order)."""
    jcfg, jfluid, jstate = dam
    jstate = _jax_substep(jcfg)(jstate, jfluid, (JInteraction.mouse((32.0, 20.0), 10.0, 0.5),))
    _, _, state = to_port(jcfg, jfluid, jstate)
    res = jcfg.grid_res
    img = frame_to_u8(bucket_frame_2d(state, res))
    pos = jstate.pos.reshape(2, -1)
    vel = jstate.vel.reshape(2, -1)
    jimg = jframe_to_u8(jrender_2d(pos, jnp.sqrt(jnp.sum(vel * vel, axis=0)), res,
                                   live=jstate.mass.reshape(-1) > 0))
    assert img.shape == (res[1] * 8, res[0] * 8, 3) and img.dtype == torch.uint8
    d = np.abs(img.numpy().astype(np.int32) - np.asarray(jimg).astype(np.int32)).max(-1)
    assert float((d > 1).mean()) <= 0.001
    # the fluid shows: 1024 particles as 5x5-pixel dots are 0.098 of the frame
    empty = frame_to_u8(render_2d(torch.zeros((2, 0)), torch.zeros(0), res))
    assert float(((img.int() - empty.int()).abs().amax(-1) > 2).float().mean()) > 0.09


def test_cli_2d_on_cpu(tmp_path, capsys, monkeypatch):
    """`run` and `render` of a 2D scene under --device cpu --mode bucketed;
    the PNG reads back equal to the frame of the same step. With no card
    and no --device, both stop."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["dam_break_2d", "--frames", "1", "--substeps", "1"]
    for cmd in ("run", "render"):
        with pytest.raises(SystemExit, match="no CUDA device visible"):
            main([cmd] + base + ["--out", str(tmp_path / "x")] * (cmd == "render"))
    main(["run"] + base + ["--device", "cpu", "--mode", "bucketed", "--window", "auto"])
    out = capsys.readouterr().out
    assert "scene=dam_break_2d N=1024 grid=(64, 64) mode=bucketed device=cpu" in out
    assert "air-window" not in out
    assert any(line.startswith("lost: 0 ") for line in out.splitlines())

    main(["render"] + base + ["--device", "cpu", "--mode", "bucketed", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2D frames 512x512" in out and "sim2d=0 migrate2d=0" in out
    sc = tscenes.dam_break_2d(device="cpu")
    state = make_step(sc.config, mode="bucketed", substeps=1)(
        tb.from_simstate(sc.state, sc.config), sc.fluid)
    want = frame_to_u8(bucket_frame_2d(state, sc.config.grid_res)).numpy()
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "frame_00000.png")), want)


@pytest.mark.parametrize("kw", [dict(bin_capacity=72), dict(fixed_point=True),
                                dict(grid_res=(16, 16, 16)), dict(clamp_hi_offset=1.0),
                                dict(domain_res=(16, 32))])
def test_2d_kernels_refuse_configs_outside_the_slice(kw):
    """Fixed point, 3D, edge clamps and a domain are outside the 2D
    kernels; K = 72 is inside (above 64 slots a cell they walk a cell's
    slots 64 at a time), as JAX's supported2d takes it."""
    from mpm_tpu_torch.core.params import SimConfig

    cfg = SimConfig(grid_res=(16, 16), clamp_lo=1.0).replace(**kw)
    if kw == dict(bin_capacity=72):
        k2d.check_supported2d(cfg)
        return
    with pytest.raises(NotImplementedError):
        k2d.check_supported2d(cfg)


def _partly_occupied_state(dim, k, c, n, vc_dtype=torch.float32):
    """A bucket state with its first n slots (in flat [K, C] order) occupied."""
    mass = torch.zeros((k, c))
    mass.view(-1)[:n] = 1.0
    return tb.BucketState(pos=torch.zeros((dim, k, c)), vel=torch.zeros((dim, k, c), dtype=vc_dtype),
                          C=torch.zeros((dim, dim, k, c), dtype=vc_dtype), mass=mass,
                          ids=torch.zeros((k, c), dtype=torch.int32), lost=None,
                          cfl_clamped=None, deferred=None, ceiling=None)


def test_roofline_of_the_2d_kernels():
    """utils/roofline's bounds of the 2D kernels at the 2D benchmark
    (100k particles in 262,144 slots, 256^2, K=4, float32): the mass of
    every slot, 32 B (sim2d) or 36 B (migrate2d, with ids) of each occupied
    slot, and every output (32 B and 40 B a slot); both bound by bytes."""
    from mpm_tpu_torch.core.params import SimConfig
    from mpm_tpu_torch.utils import roofline

    k, c, n = 4, 256 * 256, 100_000
    state = _partly_occupied_state(2, k, c, n)
    config = SimConfig(grid_res=(256, 256), bin_capacity=k)
    nbytes, ops = roofline.sim2d_work(state, config)
    assert nbytes == 36 * k * c + 32 * n == 12_637_184
    # 33 weight, 375 P2G and 146 G2P operations a slot, 8 a cell that holds one
    assert ops == 554 * n + 8 * c
    ms, by = roofline.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(12_637_184 / 3.35e12 * 1e3)
    nbytes, ops = roofline.migrate_work(state, config)
    assert nbytes == 44 * k * c + 36 * n == 15_134_336
    assert roofline.bound_ms(nbytes, ops)[1] == "bytes"


@pytest.mark.parametrize("vc_dtype", [torch.float32, torch.bfloat16])
def test_roofline_of_kernels_p_and_f(vc_dtype):
    """Kernels P and F count the inputs of occupied slots only, at their
    storage width: P reads pos, vel and C of each (60 B in float32, 36 B
    with bf16 vel and C), F its pos and ids (16 B) and the velocity of its
    cell; both read every mass and write every output."""
    from mpm_tpu_torch.core.params import SimConfig
    from mpm_tpu_torch.utils import roofline

    k, c, n = 8, 16 * 16 * 16, 5_000
    state = _partly_occupied_state(3, k, c, n, vc_dtype)
    config = SimConfig(grid_res=(16, 16, 16), bin_capacity=k)
    per_slot = 60 if vc_dtype == torch.float32 else 36
    nbytes, ops = roofline.p2g_update_work(state, config)
    assert nbytes == 4 * k * c + per_slot * n + 16 * c
    # 90 weight and 2067 P2G operations a slot, 12 a cell that holds one
    assert ops == 2157 * n + 12 * c
    out = 4 * k * c * 3 + state.vel.element_size() * 12 * k * c + 8 * k * c
    nbytes, ops = roofline.g2p_migrate_work(state, config)
    assert nbytes == 4 * k * c + 16 * n + 12 * c + out
    nbytes_emit, _ = roofline.g2p_migrate_work(state, config, emit=True)
    assert nbytes_emit == nbytes + 20 * c
