"""mode="cuda" at K = 72 on the dense 32^2 dam_break_2d of
tests/torch_wide_cases.py (64 to 81 particles a cell): three substeps
against the JAX package's mode="bucketed", within its bars; the route is
the kernels' (sim2d and migrate2d), as JAX's supported2d gives."""

import jax
import torch

from mpm_tpu.ops import bucketed as jb
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.step import make_step

from torch_wide_cases import assert_matches, dense, jax_route

torch.set_num_threads(2)


def test_k72_substeps_match_jax_2d():
    cfg, fluid, b, jcfg, jfluid, jstate = dense(2, 72)
    assert cuda_step.route(cfg) == jax_route(jcfg) == "kernel"
    step = jax.jit(lambda s, fl: jb.substep(s, jcfg, fl))
    for _ in range(3):
        jstate = step(jstate, jfluid)
    got = make_step(cfg, mode="cuda", substeps=3)(b, fluid)
    assert float(got.vel.abs().max()) > 0
    assert_matches(jstate, got)
