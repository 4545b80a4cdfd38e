"""The port's sorted engine (mpm_tpu_torch.ops.binned, segsum, binning) on
the CPU: against the port's oracle (tests/test_binned.py's bars), against
the JAX binned engine run without fused multiply-adds
(tests/torch_jax_cases.py), the blocked segment sums and the slot table.

Bars: one substep against the oracle pos 1e-6, vel/C 1e-5; a 3-frame
trajectory 2e-3; fixed point bit-deterministic across runs and particle
permutations and bit-equal to the JAX binned engine (XLA's reciprocal
decode modelled, tests/torch_xla_ref.reciprocal_decode). In float32 the
port sums each segment in float64 (ops/segsum.py) and equals the oracle on
dam_break_2d bit for bit; XLA tree-scans its float32 prefix sums, and the
JAX binned engine lands one ulp off the oracle at 1.9% of the positions
(up to 3.8e-6 at x near 47), so against JAX binned pos is held within one
float32 ulp (rtol 1.2e-7, a bar looser than 1e-6 above 8 cells) and vel/C
at 1e-5.
"""

import numpy as np
import pytest
import torch

from mpm_tpu_torch.models.scenes import get_scene
from mpm_tpu_torch.ops import binned
from mpm_tpu_torch.ops.binning import bin_slots, gather_slot_field, gather_slot_field_kc
from mpm_tpu_torch.ops.segsum import segment_bounds_for_offset, sorted_segment_sum
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.transfer import geometry

from torch_jax_cases import run_cases
from torch_xla_ref import reciprocal_decode

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_binned():
    """One substep of the JAX binned engine, no FMA, by id."""
    return run_cases({"f32": dict(scene="dam_break_2d", engine="binned", substeps=1),
                      "fixed": dict(scene="dam_break_2d", config={"fixed_point": True},
                                    engine="binned", substeps=1)})


def _assert_one_substep_close(a, b):
    np.testing.assert_array_equal(np.asarray(a["ids"]), np.asarray(b["ids"]))
    np.testing.assert_allclose(a["pos"], b["pos"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(a["vel"], b["vel"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a["C"], b["C"], rtol=0, atol=1e-5)


def _fields(s):
    return {k: getattr(s, k).numpy() for k in ("pos", "vel", "C", "ids")}


@pytest.mark.parametrize("scene_name", ["dam_break_2d", "fluid_3d_fixed_point"])
def test_binned_matches_oracle_one_substep(scene_name):
    sc = get_scene(scene_name, device="cpu")
    a = make_step(sc.config, mode="reference", substeps=1)(sc.state, sc.fluid).by_id()
    b = make_step(sc.config, mode="binned", substeps=1)(sc.state, sc.fluid).by_id()
    _assert_one_substep_close(_fields(a), _fields(b))


def test_binned_matches_oracle_trajectory():
    sc = get_scene("dam_break_2d", device="cpu")
    ref = make_step(sc.config, mode="reference")
    fast = make_step(sc.config, mode="binned")
    s_ref = s_fast = sc.state
    for _ in range(3):
        s_ref, s_fast = ref(s_ref, sc.fluid), fast(s_fast, sc.fluid)
    np.testing.assert_allclose(s_ref.by_id().pos.numpy(), s_fast.by_id().pos.numpy(),
                               rtol=0, atol=2e-3)


def test_binned_float_matches_jax_binned(jax_binned):
    sc = get_scene("dam_break_2d", device="cpu")
    got = _fields(make_step(sc.config, mode="binned", substeps=1)(sc.state, sc.fluid).by_id())
    want = jax_binned["f32"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1.2e-7, atol=1e-6)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["C"], want["C"], rtol=0, atol=1e-5)


def test_binned_fixed_point_bit_equal_to_jax(jax_binned):
    """dam_break_2d on an int32 grid (block 128), one substep."""
    sc = get_scene("dam_break_2d", device="cpu")
    cfg = sc.config.replace(fixed_point=True)
    with reciprocal_decode():
        got = make_step(cfg, mode="binned", substeps=1)(sc.state, sc.fluid).by_id()
    for k, v in _fields(got).items():
        np.testing.assert_array_equal(v, jax_binned["fixed"][k], err_msg=k)


def test_fixed_point_bit_determinism():
    """Bit-identical across runs and across a permutation of the particles
    (integer sums commute; MLSMPM3DFluidMultithreadNew.cs:336-339)."""
    sc = get_scene("fluid_3d_fixed_point", device="cpu")
    step = make_step(sc.config, mode="binned", substeps=1)
    out1 = step(sc.state, sc.fluid)
    out2 = step(sc.state, sc.fluid)
    assert torch.equal(out1.pos, out2.pos) and torch.equal(out1.vel, out2.vel)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(sc.state.num_particles))
    out3 = step(sc.state.permute(perm), sc.fluid)
    a, b = out1.by_id(), out3.by_id()
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel) and torch.equal(a.C, b.C)


def test_sorted_segment_sum_conserves_mass():
    """P2G through the sorted segment sums conserves mass (rtol 1e-6)."""
    sc = get_scene("fluid_3d_fixed_point", device="cpu")
    cfg = sc.config.replace(fixed_point=False)
    state, seg_start = binned.sort_by_cell(sc.state, cfg)
    grid = binned.p2g(state, geometry(state.pos, cfg), seg_start, cfg, sc.fluid)
    np.testing.assert_allclose(float(grid.mass.sum()), float(sc.state.mass.sum()), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_blocked_segment_sum_exactness(dtype):
    """Against direct per-segment sums, segments straddling block
    boundaries included (block 64): float32 within 1e-4
    (tests/test_binned.py), int32 exact, wrapping as XLA's int32 does."""
    rng = np.random.RandomState(1)
    seg_lens = rng.randint(0, 60, size=300)
    starts = np.concatenate([[0], np.cumsum(seg_lens)])[:-1]
    ends = starts + seg_lens
    n = int(ends[-1])
    if dtype == "float32":
        x = rng.randn(2, n).astype(np.float32)
    else:
        x = rng.randint(-2**30, 2**30, size=(2, n)).astype(np.int32)
    got = sorted_segment_sum(torch.from_numpy(x), torch.from_numpy(starts),
                             torch.from_numpy(ends), block=64).numpy()
    if dtype == "float32":
        want = np.stack([x[:, s:e].sum(-1) for s, e in zip(starts, ends)], axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        want = np.stack([x[:, s:e].astype(np.int64).sum(-1) for s, e in zip(starts, ends)],
                        axis=-1)
        np.testing.assert_array_equal(got, ((want + 2**31) % 2**32 - 2**31).astype(np.int32))


def test_segment_bounds_match_jax():
    """The tap segments of the sorted order equal the JAX package's."""
    import jax.numpy as jnp

    from mpm_tpu.ops.segsum import segment_bounds_for_offset as jbounds

    seg = np.array([0, 0, 3, 3, 7, 9, 12], np.int32)
    for off in (-3, -1, 0, 2, 5):
        s, e = segment_bounds_for_offset(torch.from_numpy(seg), off, 6)
        js, je = jbounds(jnp.asarray(seg), off, 6)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_bin_slots_layout():
    """Every particle lands in its own cell's slot, no overflow on the
    reference scene, and both packings equal the JAX package's."""
    import jax.numpy as jnp

    from mpm_tpu.ops import binning as jbinning

    sc = get_scene("dam_break_2d", device="cpu")
    state, seg_start = binned.sort_by_cell(sc.state, sc.config)
    slots = bin_slots(seg_start, sc.config, state.num_particles)
    assert int(slots.overflow) == 0
    assert int(slots.count.sum()) == sc.state.num_particles
    mass_b = gather_slot_field(state.mass, slots)
    np.testing.assert_allclose(float(mass_b.sum()), float(sc.state.mass.sum()), rtol=1e-6)
    js = jbinning.bin_slots(jnp.asarray(seg_start.numpy()), _jcfg(), state.num_particles)
    np.testing.assert_array_equal(slots.slot_particle.numpy(), np.asarray(js.slot_particle))
    np.testing.assert_array_equal(
        gather_slot_field_kc(state.pos, slots).numpy(),
        np.asarray(jbinning.gather_slot_field_kc(jnp.asarray(state.pos.numpy()), js)))


def _jcfg():
    from mpm_tpu.models.scenes import get_scene as jget

    return jget("dam_break_2d").config
