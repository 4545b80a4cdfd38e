"""The sharded air window (YWindow(mesh=...) over CPU slabs) against the
benchmark's plain reference (bench_torch/reference/sim.py, which imports
nothing of the program): the slabs concatenated plainly along the cell
axis are stepped by the reference and compared by particle id with the
sharded window's answer. Then the slab exchange's spans (one a substep and
an exchange) and its byte counter (`parallel.domain.halo_bytes`: planes x
fields x element bytes of what the exchanges copy)."""

from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_torch.reference import compare, sim as ref
from mpm_tpu_torch.models.scenes import benchmark_scene
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.parallel import domain

GRID = (16, 24, 16)
N = 3000
SUBSTEPS = 2
FIELDS = ("pos", "vel", "C", "mass", "ids")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _scene(seed: int, storage: str):
    """The small benchmark pool with a seeded jitter of +-0.04 cells."""
    sc = benchmark_scene(N, grid_res=GRID, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    noise = torch.rand(sc.state.pos.shape, generator=gen)
    sc.state.pos = (sc.state.pos + noise * 0.08 - 0.04).contiguous()
    return sc._replace(config=sc.config.replace(storage_dtype=storage))


def _params(config, fluid) -> ref.Params:
    def num(x):
        return x.tolist()

    return ref.Params(
        grid=tuple(config.grid_res), K=config.bin_capacity,
        storage=torch.bfloat16 if config.storage_dtype == "bfloat16" else torch.float32,
        eos_power_static=config.eos_power_static, bc_band_lo=config.bc_band_lo,
        bc_band_hi=config.bc_band_hi, clamp_lo=config.clamp_lo,
        clamp_hi_offset=config.clamp_hi_offset, wall_min=config.wall_min,
        wall_max_offset=config.wall_max_offset, wall_stiffness=config.wall_stiffness,
        dt=num(fluid.dt), gravity=tuple(num(fluid.gravity)), rest_density=num(fluid.rest_density),
        dynamic_viscosity=num(fluid.dynamic_viscosity), eos_stiffness=num(fluid.eos_stiffness),
        eos_power=num(fluid.eos_power), pressure_floor=num(fluid.pressure_floor))


def _concat(state: domain.ShardedState) -> ref.State:
    return ref.State(*(torch.cat([getattr(s, f) for s in state.slabs], dim=-1) for f in FIELDS))


def _window(sc, slabs: int) -> YWindow:
    return YWindow(sc.config, mode="cuda", substeps=SUBSTEPS, headroom=4,
                   mesh=domain.SlabMesh.on("cpu", slabs))


@pytest.mark.parametrize("seed", (11, 2**31 + 7))
@pytest.mark.parametrize("storage", ("float32", "bfloat16"))
@pytest.mark.parametrize("slabs", (2, 4))
def test_sharded_window_equals_the_plain_reference(slabs, storage, seed):
    sc = _scene(seed, storage)
    win = _window(sc, slabs)
    s0 = win.init(sc.state)
    assert win.wy < GRID[1]  # a windowed config: the ceiling band is live
    s1 = win.step(s0, sc.fluid)
    want = ref.run(_concat(s0), _params(sc.config, sc.fluid), SUBSTEPS)
    got = _concat(s1)
    assert int(s1.lost) == want.lost == 0 and int(s1.ceiling) == want.ceiling
    _, bad = compare.by_id(got.pos, got.ids, N)
    assert bad == 0
    gaps = compare.state_gaps(got, want, N)
    assert gaps == {"pos_gap": 0.0, "vel_gap": 0.0, "C_gap": 0.0}, gaps
    for f in FIELDS:  # slot for slot
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _frame(slabs: int, storage: str = "float32"):
    """(a sharded frame of SUBSTEPS on `slabs` CPU slabs, its input state)."""
    sc = _scene(3, storage)
    win = _window(sc, slabs)
    state = win.init(sc.state)
    frame = domain.make_sharded_bucket_step(win.config, win.mesh, SUBSTEPS, mode="cuda")
    return (lambda: frame(state, sc.fluid)), state


@pytest.mark.parametrize("slabs", (2, 4))
def test_shard_spans_open_once_a_substep_and_exchange(slabs):
    frame, _ = _frame(slabs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
    names = collections.Counter(e.name for e in prof.events() if e.name.startswith("mpm."))
    assert names["mpm.shard.substep"] == SUBSTEPS
    assert names["mpm.shard.halo"] == SUBSTEPS
    assert names["mpm.shard.grid"] == 2 * SUBSTEPS  # mass, then velocity
    assert names["mpm.shard.counters"] == 1  # once a frame
    assert names["mpm.kernel.p2g_shard"] == 2 * slabs * SUBSTEPS  # both stages, every slab
    assert names["mpm.kernel.g2p"] == slabs * SUBSTEPS


@pytest.mark.parametrize("storage", ("float32", "bfloat16"))
@pytest.mark.parametrize("slabs", (2, 4))
def test_halo_bytes_count_the_copied_planes(slabs, storage):
    frame, state = _frame(slabs, storage)
    b0 = domain.halo_bytes
    frame()
    moved = domain.halo_bytes - b0
    s = state.slabs[0]
    k = s.mass.shape[0]
    pc = s.mass.shape[-1] // (GRID[0] // slabs)
    vc = 2 if storage == "bfloat16" else 4
    slot = 3 * 4 + 3 * vc + 9 * vc + 4 + 4  # pos, vel, C, mass, ids
    boundaries = 2 * (slabs - 1)  # each inner boundary, both ways
    state_halo = boundaries * domain.HALO * pc * k * slot
    grids = boundaries * 2 * pc * 4 * (1 + 3)  # 2 planes of mass, then of velocity
    assert moved == SUBSTEPS * (state_halo + grids)
