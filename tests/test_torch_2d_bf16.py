"""bf16 vel/C storage on the 2D path, on the CPU: make_step(mode="cuda")
(the sim2d and migrate2d wrappers' plain versions, which the kernels equal
bit for bit on the card) against the JAX package's XLA bucket engine run
without fused multiply-adds (tests/torch_jax_cases.py), and against its 2D
Pallas kernels in interpret mode (kernels2d.substep2d, which load bf16
vel/C, kernels2d.py:76-77, and store the state's dtype, :476-477).

Bars: against the XLA engine bit for bit, every field and counter (the bar
reached; the fluid and the mouse reach XLA as arguments, as make_step
passes them: folded in as constants they move 15-20 of C's 65,536 values
below 2e-8). Against the interpret-mode kernels the JAX package's bf16 bar,
rtol 0.01 and atol 1e-4 (tests/test_fused.py:163-182) on vel and C, pos
within 1e-5, ids and counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models import scenes as jscenes
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.pallas import kernels2d as jk2d
from mpm_tpu_torch.models.scenes import dam_break_2d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.cuda import substep2d as k2d
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step

from torch_jax_cases import run_cases

torch.set_num_threads(2)

BF16 = dict(storage_dtype="bfloat16", bin_capacity=8)
MOUSE = [[32.0, 20.0, 10.0, 0.5, 1.0, 1.0]]  # centre, radius, strength, inv_falloff, active
FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def _scene():
    sc = dam_break_2d(device="cpu")
    cfg = sc.config.replace(**BF16)
    return cfg, sc.fluid, tb.from_simstate(sc.state, cfg)


def _arrays(b):
    return {f: getattr(b, f).float().numpy() if getattr(b, f).is_floating_point()
            else getattr(b, f).numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def xla():
    cfg, _, b = _scene()
    st = _arrays(b)
    spec = dict(scene="dam_break_2d", config=BF16, engine="bucketed", substeps=4)
    return run_cases({"free": spec, "mouse": dict(spec, spheres=MOUSE)},
                     {"free": st, "mouse": st})


def test_bf16_2d_is_in_the_kernels_envelope():
    cfg, _, b = _scene()
    assert b.vel.dtype == torch.bfloat16 and cuda_step.route(cfg) == "kernel"
    k2d.check_supported2d(cfg)


@pytest.mark.parametrize("case", ["free", "mouse"])
def test_bf16_2d_matches_jax_xla_bit_for_bit(xla, case):
    cfg, fluid, b = _scene()
    inter = (Interaction.mouse((32.0, 20.0), radius=10.0, strength=0.5),) if case == "mouse" \
        else ()
    got = make_step(cfg, mode="cuda", substeps=4)(b, fluid, inter)
    assert got.vel.dtype == torch.bfloat16 and got.C.dtype == torch.bfloat16
    g = _arrays(got)
    for f in FIELDS:
        np.testing.assert_array_equal(g[f], xla[case][f], err_msg=f)


def test_bf16_2d_matches_pallas_kernels_interpret():
    """Two substeps of the JAX package's 2D kernels in interpret mode on a
    bf16 state, at the bf16 bar."""
    j = jscenes.get_scene("dam_break_2d")
    jcfg = j.config.replace(**BF16)
    js = jax.jit(lambda s: jb.from_simstate(s, jcfg))(j.state)
    for _ in range(2):
        js = jk2d.substep2d(js, jcfg, j.fluid, (), interpret=True)
    cfg, fluid, b = _scene()
    got = make_step(cfg, mode="cuda", substeps=2)(b, fluid)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-5)
    for f in ("vel", "C"):
        want = np.asarray(getattr(js, f).astype(jnp.float32))
        np.testing.assert_allclose(getattr(got, f).float().numpy(), want, rtol=0.01, atol=1e-4,
                                   err_msg=f)
    for f in ("lost", "deferred"):
        assert int(getattr(got, f)) == int(getattr(js, f)), f


def test_bf16_2d_wrappers_keep_bf16_and_ids():
    """sim2d stores vel and C as bf16 (one rounding at the store, as the
    float32 path then .to(bf16)); migrate2d moves their bits."""
    cfg, fluid, b = _scene()
    s1 = k2d.sim2d(b, cfg, fluid)
    f32 = k2d.sim2d(tb.BucketState(*[getattr(b, f).float() if f in ("vel", "C")
                                     else getattr(b, f) for f in FIELDS]),
                    cfg.replace(storage_dtype="float32"), fluid)
    assert s1.vel.dtype == torch.bfloat16
    assert torch.equal(s1.vel, f32.vel.to(torch.bfloat16))
    assert torch.equal(s1.C, f32.C.to(torch.bfloat16))
    s2 = k2d.migrate2d(s1, cfg)
    occ = s2.mass > 0
    assert s2.vel.dtype == torch.bfloat16 and int(occ.sum()) == 1024
    assert sorted(s2.ids[occ].tolist()) == list(range(1024))
