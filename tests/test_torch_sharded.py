"""The port's x-slab decomposition (mpm_tpu_torch/parallel/domain.py) on
the CPU (the plain versions): the sharded step on 2, 4 and 8 slabs with
float32 and bf16 storage against the JAX XLA engine and, bit for bit,
against the port's unsharded engine (tests/torch_shard_cases.py states the
bars); a y-windowed config on 2 and 4 slabs against the unsharded engine;
every case a chunk of 3 substeps, so that the slab exchange fills the
padded slabs in place after the chunk's first; a chunk leaves its input
state as it was; the exchanges a chunk runs; the demo and the refusals.
Fixed point, the counter gate and kernel F's shard mode are
tests/test_torch_sharded_fixed.py, the two kernel-P stages
tests/test_torch_shard_kernels.py, the air window over a slab mesh and
`run --shards` tests/test_torch_shard_window.py."""

import pytest
import torch

from mpm_tpu_torch.__main__ import main as cli_main
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.cuda import halo_fill
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import window_config
from mpm_tpu_torch.parallel import domain
from torch_shard_cases import assert_bit_equal, check_matrix_case, configs, initial, scenes

torch.set_num_threads(2)


# "full": every slot of the interior cells occupied (K=8, the comparison's
# K), on 2 slabs, one at each global end of the grid
@pytest.mark.parametrize("storage, n_slabs", [(s, n) for s in ("f32", "bf16") for n in (2, 4, 8)]
                         + [("full", 2)])
def test_sharded_step_matches_jax_and_unsharded(storage, n_slabs):
    check_matrix_case(storage, n_slabs)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_sharded_windowed_step_matches_unsharded(n_slabs):
    """A y-windowed config (the scene's 16 planes of a 32-high domain: the
    true domain's walls, the ceiling band live): a chunk of 3 sharded
    substeps equals 3 of the unsharded engine slot for slot, counters
    included."""
    _, t, _ = scenes()
    _, tcfg = configs("f32")
    wcfg = window_config(tcfg.replace(grid_res=(16, 32, 16)), 16)
    b0 = tb.from_simstate(t.state, wcfg)
    mesh = domain.SlabMesh.on("cpu", n_slabs)
    got = domain.make_sharded_bucket_step(wcfg, mesh, substeps=3)(
        domain.shard_bucket_state(b0, wcfg, mesh), t.fluid)
    want = make_step(wcfg, mode="bucketed", substeps=3)(b0, t.fluid)
    g = domain.gather_bucket_state(got)
    assert_bit_equal(g, want)
    for f in domain.COUNTERS:
        assert int(getattr(g, f)) == int(getattr(want, f)), f


def test_chunk_leaves_its_input_state_unchanged():
    """A chunk writes only buffers it made: every tensor of its input
    ShardedState (4 slabs, the counters too) keeps its bits, and a second
    chunk from the same input gives the same answer."""
    _, tcfg = configs("bf16")
    mesh = domain.SlabMesh.on("cpu", 4)
    state = domain.shard_bucket_state(initial("bf16"), tcfg, mesh)
    kept = [{f: getattr(s, f).clone() for f in (*domain.FIELDS, *domain.COUNTERS)}
            for s in state.slabs]
    step = domain.make_sharded_bucket_step(tcfg, mesh, substeps=3)
    out = step(state, scenes()[1].fluid)
    for s, k in zip(state.slabs, kept):
        for f, x in k.items():
            assert torch.equal(getattr(s, f), x), f
    again = step(state, scenes()[1].fluid)
    assert_bit_equal(domain.gather_bucket_state(again), domain.gather_bucket_state(out))


@pytest.mark.parametrize("n_slabs, substeps, chunks", [(2, 3, 2), (4, 1, 1)])
def test_exchange_schedule_of_a_chunk(monkeypatch, n_slabs, substeps, chunks):
    """After k chunks of S substeps on n slabs: a full exchange a chunk (its
    first substep's state halo), S - 1 in-place state fills and 2 S grid
    fills, each over all n slabs; on the CPU each runs the plain version,
    so kernel HF's counters stay where they were."""
    _, tcfg = configs("f32")
    mesh = domain.SlabMesh.on("cpu", n_slabs)
    state = domain.shard_bucket_state(initial("f32"), tcfg, mesh)
    step = domain.make_sharded_bucket_step(tcfg, mesh, substeps=substeps)
    ran, run = [], domain._Exchange.run

    def counted(ex, kind, table):
        assert ex.n == len(table) // (2 * len(domain.FIELDS) if kind == "full"
                                      else len(domain.FIELDS) if kind == "state" else 1)
        ran.append(kind)
        return run(ex, kind, table)

    monkeypatch.setattr(domain._Exchange, "run", counted)
    kernel0 = (halo_fill.fill_launches, halo_fill.full_launches, halo_fill.copies)
    for _ in range(chunks):
        state = step(state, scenes()[1].fluid)
    assert ran.count("full") == chunks
    assert ran.count("state") == chunks * (substeps - 1)
    assert ran.count("grid") == chunks * 2 * substeps
    assert (halo_fill.fill_launches, halo_fill.full_launches, halo_fill.copies) == kernel0


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
