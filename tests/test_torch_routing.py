"""mode="cuda"'s routing (mpm_tpu_torch.ops.cuda.step.route) against the
JAX package's (fused.substep_fused: kernels2d.supported2d,
fused.fused_supported, p2g_fused.p2g_update_supported; the per-pass
bucket_kernels.pallas_supported; MPM_PALLAS_OLD) over a grid of configs,
and a fixed-point 2D step through mode="cuda" on the CPU against the JAX
XLA engine.

Bars: the route equal to JAX's for every config of the grid, at any K
(the port's kernels walk a cell's slots 64 at a time above 64). A windowed
config outside the envelope raises ValueError in both. Clamps that let
particles into the edge planes, which the JAX package assumes away
(mpm_tpu/ops/bucketed.py:16-19), raise NotImplementedError under
mode="cuda". The fixed-point 2D step bit for bit against the XLA engine
run without FMA (its reciprocal decode modelled).
"""

import itertools

import numpy as np
import pytest
import torch

from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.ops.window import window_config as jwindow_config
from mpm_tpu.ops.pallas import bucket_kernels as jbk
from mpm_tpu.ops.pallas import fused as jfused
from mpm_tpu.ops.pallas import kernels2d as jk2d
from mpm_tpu.ops.pallas import p2g_fused as jp2g
from mpm_tpu_torch.core.params import SimConfig
from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.step import make_step

from torch_jax_cases import run_cases
from torch_xla_ref import reciprocal_decode

torch.set_num_threads(2)

STORAGE = {"f32": {}, "bf16": {"storage_dtype": "bfloat16"}, "fixed": {"fixed_point": True}}
GRID = list(itertools.product((2, 3), (8, 40, 72), STORAGE, (False, True)))


def jax_route(cfg: JConfig, old: bool) -> str:
    """Where the JAX package's mode="pallas" runs a config."""
    if old:  # step.py under MPM_PALLAS_OLD=1: bucket_kernels.substep
        return "planes" if jbk.pallas_supported(cfg) else "plain"
    if cfg.dim == 2 and jk2d.supported2d(cfg, cfg.bin_capacity):
        return "kernel"
    if jfused.fused_supported(cfg, cfg.bin_capacity) and not (
            cfg.fixed_point and not jp2g.p2g_update_supported(cfg)):
        return "kernel"
    if cfg.domain_res is not None:
        return "raise"
    return "planes" if jbk.pallas_supported(cfg) else "plain"


def port_route(cfg: SimConfig, old: bool) -> str:
    try:
        return cuda_step.route(cfg, per_pass=old)
    except NotImplementedError:
        return "raise"


@pytest.mark.parametrize("dim,k,storage,old", GRID,
                         ids=[f"{d}d-k{k}-{s}-{'old' if o else 'fused'}" for d, k, s, o in GRID])
def test_route_matches_jax(dim, k, storage, old):
    kw = dict(grid_res=(16,) * dim, bin_capacity=k, **STORAGE[storage])
    want = jax_route(JConfig(**kw), old)
    got = port_route(SimConfig(**kw), old)
    assert got == want


def test_route_reads_the_env(monkeypatch):
    cfg = SimConfig(grid_res=(16, 16, 16), bin_capacity=8)
    monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    assert cuda_step.route(cfg) == "planes"
    monkeypatch.setenv("MPM_PALLAS_OLD", "0")
    assert cuda_step.route(cfg) == "kernel"


def test_windowed_outside_the_envelope_raises():
    """fused.py:1171-1187: a windowed config the kernels do not take
    raises rather than run without the ceiling band (a fixed-point 2D
    config with a domain, in JAX and in the port); a windowed config at
    K = 72 routes to the kernels, as in JAX."""
    from mpm_tpu_torch.ops.window import window_config

    kw = dict(grid_res=(16, 16), domain_res=(16, 32), fixed_point=True, bin_capacity=8)
    assert jax_route(JConfig(**kw), False) == "raise"
    cfg2 = SimConfig(**kw)
    assert cuda_step.route(cfg2) == "plain"
    sc2 = dam_break_2d(device="cpu")
    b2 = tb.from_simstate(sc2.state, sc2.config.replace(**kw))
    with pytest.raises(ValueError, match="windowed"):
        make_step(cfg2, mode="cuda", substeps=1)(b2, sc2.fluid)

    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    kw = dict(grid_res=(16, 32, 16), bin_capacity=72)
    cfg = window_config(sc.config.replace(**kw), 16)
    jcfg = jwindow_config(JConfig(**{**kw, "clamp_lo": 2.0, "clamp_hi_offset": 2.0}), 16)
    assert cuda_step.route(cfg) == jax_route(jcfg, False) == "kernel"
    b = tb.from_simstate(sc.state, cfg)
    got = make_step(cfg, mode="cuda", substeps=1)(b, sc.fluid)
    want = make_step(cfg, mode="bucketed", substeps=1)(b, sc.fluid)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.ids, want.ids)


@pytest.mark.parametrize("over", [{"bin_capacity": 72}, {"clamp_lo": 0.5},
                                  {"clamp_hi_offset": 1.0}], ids=["k72", "lo", "hi"])
def test_beyond_the_kernels_raises(over):
    """mode="cuda" refuses what the port's kernels do not take, naming
    mode="bucketed"; the plain engine is never taken in their place. Only
    edge clamps are refused: K = 72 routes to the kernels (their plain
    versions on the CPU) and equals mode="bucketed" bit for bit."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    cfg = sc.config.replace(**over)
    b = tb.from_simstate(sc.state, cfg)
    if "bin_capacity" in over:
        assert cuda_step.route(cfg) == "kernel"
        got = make_step(cfg, mode="cuda", substeps=2)(b, sc.fluid)
        want = make_step(cfg, mode="bucketed", substeps=2)(b, sc.fluid)
        for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        return
    with pytest.raises(NotImplementedError, match="mode='bucketed'"):
        make_step(cfg, mode="cuda", substeps=1)(b, sc.fluid)


def test_k40_cuda_mode_equals_bucketed():
    """K = 40 routes to the kernels (their plain versions on the CPU) and
    equals mode="bucketed" bit for bit."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
    cfg = sc.config.replace(bin_capacity=40)
    assert cuda_step.route(cfg) == "kernel"
    b = tb.from_simstate(sc.state, cfg)
    got = make_step(cfg, mode="cuda", substeps=2)(b, sc.fluid)
    want = make_step(cfg, mode="bucketed", substeps=2)(b, sc.fluid)
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_fixed_point_2d_cuda_mode_matches_jax_xla():
    """dam_break_2d on an int32 grid (K=8), 3 substeps of mode="cuda" on the
    CPU (routed to the plain engine) equal the JAX XLA engine's bit for bit,
    every field and counter."""
    sc = dam_break_2d(device="cpu")
    over = {"fixed_point": True, "bin_capacity": 8}
    cfg = sc.config.replace(**over)
    assert cuda_step.route(cfg) == "plain"
    b = tb.from_simstate(sc.state, cfg)
    fields = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")
    st = {f: getattr(b, f).numpy() for f in fields}
    want = run_cases({"fx": dict(scene="dam_break_2d", config=over, engine="bucketed",
                                 substeps=3)}, {"fx": st})["fx"]
    with reciprocal_decode():
        got = make_step(cfg, mode="cuda", substeps=3)(b, sc.fluid)
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)
