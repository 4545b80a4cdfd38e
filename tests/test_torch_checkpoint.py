"""The port's checkpoints (mpm_tpu_torch/utils/checkpoint.py) interchange
with the JAX package's (mpm_tpu/utils/checkpoint.py): the port reads the
JAX package's float32 and bf16 BucketStates and its SimStates with equal
tensors, the JAX package reads the port's float32 states with equal
arrays, and both write the same `__meta__` keys and values."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.window import window_config as jwindow_config
from mpm_tpu.utils import checkpoint as jck
from mpm_tpu_torch import convert
from mpm_tpu_torch.models.scenes import fluid_3d as tfluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.window import window_config
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

SCENE = dict(grid_res=16, box=8.0, spacing=0.8)
BUCKET_FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")
SIM_FIELDS = ("pos", "vel", "C", "mass", "ids")
CASES = {"f32": {}, "bf16": {"storage_dtype": "bfloat16"}, "windowed": {}, "simstate": {}}


def _configs(case):
    j = jfluid_3d(**SCENE)
    t = tfluid_3d(**SCENE, device="cpu")
    jcfg = j.config.replace(bin_capacity=8, **CASES[case])
    tcfg = t.config.replace(bin_capacity=8, **CASES[case])
    if case == "windowed":
        jcfg = jwindow_config(jcfg.replace(grid_res=(16, 32, 16)), 16)
        tcfg = window_config(tcfg.replace(grid_res=(16, 32, 16)), 16)
    return j, t, jcfg, tcfg


def _np(x) -> np.ndarray:
    """A tensor's or array's values in numpy, floats (bf16 widened exactly)
    as float32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _assert_states_equal(jstate, tstate, fields):
    for f in fields:
        a, b = getattr(jstate, f), getattr(tstate, f)
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
        assert np.asarray(a).shape == tuple(b.shape), f


def _jax_state(case, j, jcfg):
    if case == "simstate":
        return j.state
    b = jb.from_simstate(j.state, jcfg)
    return dataclasses.replace(b, deferred=jnp.asarray(5, jnp.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_port_reads_jax_checkpoints(tmp_path, case):
    j, _, jcfg, _ = _configs(case)
    jstate = _jax_state(case, j, jcfg)
    fluid = j.fluid.replace(dt=0.15)
    path = str(tmp_path / "j.npz")
    jck.save(path, jstate, fluid, jcfg, extra={"frame": 7})
    state, tfluid, cfg, extra = tck.load(path)
    assert type(state).__name__ == type(jstate).__name__
    fields = SIM_FIELDS if case == "simstate" else BUCKET_FIELDS
    _assert_states_equal(jstate, state, fields)
    if case == "bf16":
        assert state.vel.dtype == state.C.dtype == torch.bfloat16
    for f in dataclasses.fields(tfluid):
        np.testing.assert_array_equal(np.asarray(getattr(fluid, f.name)),
                                      getattr(tfluid, f.name).numpy())
    assert float(tfluid.dt) == np.float32(0.15)
    assert extra == {"frame": 7} and convert.config_from_fields(cfg).grid_res == jcfg.grid_res
    assert cfg.get("domain_res") == (list(jcfg.domain_res) if jcfg.domain_res else None)


@pytest.mark.parametrize("case", ["f32", "windowed", "simstate"])
def test_jax_reads_port_checkpoints(tmp_path, case):
    j, t, jcfg, tcfg = _configs(case)
    tstate = (t.state if case == "simstate" else
              tb.from_simstate(t.state, tcfg).replace(cfl_clamped=torch.tensor(3, dtype=torch.int32)))
    path = str(tmp_path / "t.npz")
    tck.save(path, tstate, t.fluid, tcfg)
    jstate, jfluid, cfg, extra = jck.load(path)
    assert type(jstate).__name__ == type(tstate).__name__
    _assert_states_equal(jstate, tstate, SIM_FIELDS if case == "simstate" else BUCKET_FIELDS)
    for f in dataclasses.fields(t.fluid):
        np.testing.assert_array_equal(np.asarray(getattr(jfluid, f.name)),
                                      getattr(t.fluid, f.name).numpy())
    assert extra == {}
    jpath = str(tmp_path / "j.npz")
    jck.save(jpath, _jax_state(case, j, jcfg), j.fluid, jcfg)
    with np.load(path) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        mt, mj = (json.loads(bytes(z["__meta__"]).decode()) for z in (zt, zj))
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
    assert mt == mj and sorted(mt) == ["config", "extra", "state_class"]
    assert "dtype" not in mt["config"]


def test_bf16_round_trip_and_jax_layout(tmp_path):
    """The port writes bf16 leaves as the JAX package does (2-byte void
    records) and reads them back bit for bit; the JAX package's own load
    refuses them (ROADMAP.md §3)."""
    j, t, jcfg, tcfg = _configs("bf16")
    tstate = tb.from_simstate(t.state, tcfg)
    tstate = tstate.replace(vel=torch.randn(tstate.vel.shape,
                                            generator=torch.Generator().manual_seed(0))
                            .to(torch.bfloat16))
    path = str(tmp_path / "t.npz")
    tck.save(path, tstate, t.fluid, tcfg)
    back, _, cfg, _ = tck.load(path)
    for f in BUCKET_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tstate, f)), f
    jpath = str(tmp_path / "j.npz")
    jck.save(jpath, jb.from_simstate(j.state, jcfg), j.fluid, jcfg)
    with np.load(path) as zt, np.load(jpath) as zj:
        assert zt["state_1"].dtype == zj["state_1"].dtype == np.dtype("V2")
    assert cfg["storage_dtype"] == "bfloat16"
    with pytest.raises(TypeError):
        jck.load(jpath)


def test_sharded_state_is_gathered(tmp_path):
    _, t, _, tcfg = _configs("f32")
    b = tb.from_simstate(t.state, tcfg)
    sharded = domain.shard_bucket_state(b, tcfg, domain.SlabMesh.on("cpu", 2))
    path = str(tmp_path / "s.npz")
    tck.save(path, sharded, t.fluid, tcfg)
    back, _, _, _ = tck.load(path)
    for f in BUCKET_FIELDS:
        assert torch.equal(getattr(back, f), getattr(b, f)), f


def test_old_checkpoint_gets_zero_counters(tmp_path):
    """A bucket checkpoint written before the later counters existed loads
    with them as zeros, as the JAX package's does."""
    _, t, _, tcfg = _configs("f32")
    b = tb.from_simstate(t.state, tcfg)
    path = str(tmp_path / "t.npz")
    tck.save(path, b, t.fluid, tcfg)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k not in ("state_6", "state_7", "state_8")}
    np.savez_compressed(path, **old)
    back, _, _, _ = tck.load(path)
    assert int(back.cfl_clamped) == int(back.deferred) == int(back.ceiling) == 0
    assert torch.equal(back.ids, b.ids)
