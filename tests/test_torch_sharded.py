"""The port's x-slab decomposition (mpm_tpu_torch/parallel/domain.py) on
the CPU (the plain versions): the sharded step on 2, 4 and 8 slabs with
float32 and bf16 storage against the JAX XLA engine and, bit for bit,
against the port's unsharded engine (tests/torch_shard_cases.py states the
bars); the demo and the refusals. Fixed point, the counter gate and kernel
F's shard mode are tests/test_torch_sharded_fixed.py, the two kernel-P
stages tests/test_torch_shard_kernels.py, the air window over a slab mesh
and `run --shards` tests/test_torch_shard_window.py."""

import pytest
import torch

from mpm_tpu_torch.__main__ import main as cli_main
from mpm_tpu_torch.parallel import domain
from torch_shard_cases import check_matrix_case, configs

torch.set_num_threads(2)


# "full": every slot of the interior cells occupied (K=8, the comparison's
# K), on 2 slabs, one at each global end of the grid
@pytest.mark.parametrize("storage, n_slabs", [(s, n) for s in ("f32", "bf16") for n in (2, 4, 8)]
                         + [("full", 2)])
def test_sharded_step_matches_jax_and_unsharded(storage, n_slabs):
    check_matrix_case(storage, n_slabs)


def test_demo_sharded_bucket_step_on_cpu():
    domain.demo_sharded_bucket_step(2, device="cpu")


def test_slab_mesh_refusals():
    _, tcfg = configs("f32")
    for n in (3, 16):  # 16 % 3 != 0; 16 / 16 = 1 plane
        with pytest.raises(ValueError, match="slabs of >= 2 planes"):
            domain.make_sharded_bucket_step(tcfg, domain.SlabMesh.on("cpu", n))


@pytest.mark.parametrize("argv, msg", [
    (["run", "dam_break_2d", "--shards", "2"], "requires a 3D scene"),
    (["run", "fluid_3d_cpu", "--shards", "3"], "must divide grid x="),
    (["run", "fluid_3d_cpu", "--shards", "32"], "slabs of >= 2 planes"),
])
def test_cli_shards_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli_main([*argv, "--device", "cpu", "--mode", "bucketed", "--frames", "1"])
