"""The port's sort-based sharded step (mpm_tpu_torch.parallel.domain) and
its binned engine on fluid_3d (tests/test_sharded.py's small scene: 16^3,
1,000 particles, 2 substeps a call) in float32, held to the JAX package's
make_sharded_step on 4 forced host devices, run without fused
multiply-adds (tests/torch_jax_cases.py).

Bar: ids equal and pos within 2e-3 after 3 calls, tests/test_sharded.py's
bar between the sharded and the unsharded engine: the float prefix sums
need not add in XLA's order (ops/segsum.py) and XLA's CPU pow is not
correctly rounded (tests/test_torch_sorted_shard_jax.py).
"""

import numpy as np
import pytest
import torch

from mpm_tpu_torch.models.scenes import fluid_3d

from test_torch_sorted_shard_jax import SCENE_KW, capacities, port_binned, port_sharded
from torch_jax_cases import run_cases

torch.set_num_threads(2)

CALLS = 3


def _scene():
    sc = fluid_3d(device="cpu", **SCENE_KW)
    return sc._replace(config=sc.config.replace(substeps=2))


@pytest.fixture(scope="module")
def jax_sharded():
    n = _scene().state.num_particles
    return run_cases({"float4": dict(scene="fluid_3d", scene_kw=SCENE_KW,
                                     config={"substeps": 2}, engine="sharded", n_shards=4,
                                     substeps=CALLS, per_call=2, **capacities(n))})["float4"]


@pytest.mark.parametrize("engine", ["sharded4", "sharded2", "binned"])
def test_float_matches_jax_sharded(jax_sharded, engine):
    sc = _scene()
    got = (port_binned(sc, CALLS) if engine == "binned"
           else port_sharded(sc, int(engine[-1]), CALLS))
    assert got.num_particles == sc.state.num_particles, "particles lost or duplicated"
    np.testing.assert_array_equal(got.ids.numpy(), jax_sharded["ids"])
    np.testing.assert_allclose(got.pos.numpy(), jax_sharded["pos"], rtol=0, atol=2e-3)
