"""The PyTorch port's configs, scenes and conversions against the JAX
package: SimConfig and FluidParams field for field, initial states array
for array, convert.py round trips, and no JAX import in the port."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.models import scenes as jscenes
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.window import window_config as jwindow_config
from mpm_tpu_torch import convert
from mpm_tpu_torch.core.params import FluidParams
from mpm_tpu_torch.models import scenes as tscenes
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.window import window_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = [
    ("fluid_3d", {}),
    ("fluid_3d_cpu", {}),
    ("benchmark_scene", {"n_target": 20_000}),
    ("benchmark_dam_break", {"n_target": 20_000}),
]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_config_equal(jcfg, tcfg):
    jf, tf = _fields(jcfg), _fields(tcfg)
    assert jf.keys() == tf.keys()
    for key, jv in jf.items():
        if key == "dtype":
            assert np.dtype(jv).name == str(tf[key]).removeprefix("torch.")
        else:
            assert jv == tf[key], key
    assert jcfg.dres == tcfg.dres and jcfg.num_cells == tcfg.num_cells
    assert np.dtype(jcfg.vc_dtype).name == str(tcfg.vc_dtype).removeprefix("torch.")


@pytest.mark.parametrize("name,kw", SCENES, ids=[s[0] for s in SCENES])
def test_config_and_fluid_match(name, kw):
    j = getattr(jscenes, name)(**kw)
    t = getattr(tscenes, name)(**kw)
    _assert_config_equal(j.config, t.config)
    for f in dataclasses.fields(FluidParams):
        np.testing.assert_array_equal(np.asarray(getattr(j.fluid, f.name)),
                                      getattr(t.fluid, f.name).numpy())
    wy = j.config.grid_res[1] // 2
    _assert_config_equal(jwindow_config(j.config, wy), window_config(t.config, wy))


@pytest.mark.parametrize("name,kw", SCENES, ids=[s[0] for s in SCENES])
def test_initial_state_array_equal(name, kw):
    j = getattr(jscenes, name)(**kw).state
    t = getattr(tscenes, name)(**kw).state
    for f in ("pos", "vel", "C", "mass", "ids"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


def test_scene_registry_covers_3d_names():
    for name in tscenes.SCENES:
        assert name in jscenes.SCENES
    t = tscenes.get_scene("fluid_3d", grid_res=16, box=8.0, spacing=0.8)
    j = jscenes.get_scene("fluid_3d", grid_res=16, box=8.0, spacing=0.8)
    np.testing.assert_array_equal(np.asarray(j.state.pos), t.state.pos.numpy())


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_convert_round_trip(storage):
    j = jscenes.fluid_3d(grid_res=16, box=8.0, spacing=0.8)
    t = tscenes.fluid_3d(grid_res=16, box=8.0, spacing=0.8)
    jcfg = jwindow_config(j.config.replace(bin_capacity=8, storage_dtype=storage,
                                          grid_res=(16, 32, 16)), 16)
    tcfg = window_config(t.config.replace(bin_capacity=8, storage_dtype=storage,
                                          grid_res=(16, 32, 16)), 16)
    assert convert.config_from_fields(_fields(jcfg)) == tcfg

    fluid = convert.fluid_from_numpy(
        {k: np.asarray(v) for k, v in _fields(j.fluid).items()})
    for f in dataclasses.fields(FluidParams):
        assert torch.equal(getattr(fluid, f.name), getattr(t.fluid, f.name))

    s = convert.simstate_from_numpy(*(np.asarray(getattr(j.state, f)) for f in
                                      ("pos", "vel", "C", "mass", "ids")), device="cpu")
    for f in ("pos", "vel", "C", "mass", "ids"):
        assert torch.equal(getattr(s, f), getattr(t.state, f)), f

    jbs = jb.from_simstate(j.state, jcfg)
    assert jbs.vel.dtype == jcfg.vc_dtype
    got = convert.bucket_state_from_numpy(
        *(np.asarray(getattr(jbs, f)) for f in
          ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred",
           "ceiling")), device="cpu")
    want = tb.from_simstate(t.state, tcfg)
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped",
              "deferred", "ceiling"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax and
    mpm_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mpm_tpu_torch\n"
        "for m in pkgutil.walk_packages(mpm_tpu_torch.__path__, 'mpm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpm_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('mpm_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert int(res.stdout.split()[1]) >= 15


def test_sim_path_imports_no_renderer():
    """The simulation's entry points and kernel wrappers, kernel F's splat
    emission included, load without the renderer: ops never imports render."""
    code = (
        "import sys\n"
        "import mpm_tpu_torch, mpm_tpu_torch.ops.cuda.step, mpm_tpu_torch.ops.cuda.g2p_migrate\n"
        "bad = [m for m in sys.modules if m.startswith('mpm_tpu_torch.render')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
