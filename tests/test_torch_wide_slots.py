"""mode="cuda" above 64 slots a cell against the JAX package's
mode="bucketed", on the dense 16^3 fluid_3d of tests/torch_wide_cases.py
(more than 64 particles in its fullest cell): the route at K = 72, 100 and
128 (and the dense 2D scene's at K = 72) equals the JAX package's, and
three substeps at K = 72 are within the JAX package's bars.

On the CPU mode="cuda" runs the kernels' plain versions; above 64 slots
the kernels walk a cell's slots 64 at a time in slot order (csrc/
bucket_kernels.cuh, WIDE), held to these plain versions bit for bit on the
card (tests/test_torch_cuda.py). JAX's migration unrolls its select over
the K output slots, so its XLA compile grows with K (some 15 s at K = 72
on this scene): K = 100 and 128 are compared by halves in
tests/test_torch_wide_slots_halves.py, the 2D scene in
tests/test_torch_wide_slots_2d.py.
"""

import jax
import pytest
import torch

from mpm_tpu.ops import bucketed as jb
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.step import make_step

from torch_wide_cases import assert_matches, dense, jax_route

torch.set_num_threads(2)


@pytest.mark.parametrize("dim,k", [(3, 72), (3, 100), (3, 128), (2, 72)])
def test_dense_scene_is_wide_and_routes_as_jax(dim, k):
    cfg, _, b, jcfg, _, _ = dense(dim, k)
    assert int((b.mass > 0).sum(0).max()) > 64
    assert cuda_step.route(cfg, per_pass=False) == jax_route(jcfg) == "kernel"


def test_k72_substeps_match_jax():
    """Three substeps of mode="cuda" against the JAX engine's."""
    cfg, fluid, b, jcfg, jfluid, jstate = dense(3, 72)
    step = jax.jit(lambda s, fl: jb.substep(s, jcfg, fl))
    for _ in range(3):
        jstate = step(jstate, jfluid)
    got = make_step(cfg, mode="cuda", substeps=3)(b, fluid)
    assert float(got.vel.abs().max()) > 0
    assert_matches(jstate, got)
