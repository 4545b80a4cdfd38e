"""The port's `run` entry point end to end on the CPU: the path that
`python -m mpm_tpu_torch run <scene> --window auto` drives, against the JAX
package's CPU path for the same command (mpm_tpu.__main__._build: mode
"bucketed" under YWindow), plus the CLI itself."""

import numpy as np
import pytest
import torch

from mpm_tpu.models.scenes import fluid_3d as jfluid_3d
from mpm_tpu.ops import bucketed as jb
from mpm_tpu.ops.window import YWindow as JYWindow
from mpm_tpu_torch.__main__ import build, main
from mpm_tpu_torch.models.scenes import fluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.step import make_step

torch.set_num_threads(2)


def test_run_entry_matches_jax_path():
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8)
    sc = sc._replace(config=sc.config.replace(bin_capacity=8, grid_res=(16, 32, 16)))
    jsc = jfluid_3d(grid_res=16, box=8.0, spacing=0.8)
    jcfg = jsc.config.replace(bin_capacity=8, grid_res=(16, 32, 16))

    step, state, win = build(sc, mode="auto", window="auto", substeps=None)
    jwin = JYWindow(jcfg, mode="bucketed", substeps=jcfg.substeps, donate=False,
                    sync_polls=True)
    jstate = jwin.init(jsc.state)
    assert win.wy == jwin.wy < 32
    for _ in range(2):
        state = step(state, sc.fluid, ())
        jstate = jwin.step(jstate, jsc.fluid, ())
        assert win.wy == jwin.wy
    got = tb.to_simstate(state)
    want = jb.to_simstate(jstate, jcfg.num_particles)
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy())
    np.testing.assert_allclose(np.asarray(want.pos), got.pos.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(want.vel), got.vel.numpy(), atol=1e-5)
    assert int(state.lost) == int(jstate.lost) == 0
    assert win.interference == 0


def test_step_modes_on_cpu():
    """On the CPU "auto" and "cuda" both run the plain version: a CPU tensor
    takes the plain version by the wrappers' dispatch rule."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8)
    cfg = sc.config.replace(bin_capacity=8)
    s0 = tb.from_simstate(sc.state, cfg)
    outs = [make_step(cfg, mode=m, substeps=1)(s0, sc.fluid)
            for m in ("bucketed", "auto", "cuda")]
    for o in outs[1:]:
        for f in ("pos", "vel", "C", "mass", "ids", "deferred"):
            assert torch.equal(getattr(o, f), getattr(outs[0], f)), f
    with pytest.raises(ValueError):
        make_step(cfg, mode="pallas")


def test_cli_run_and_info(capsys, monkeypatch):
    """With no card, `run` takes the CPU only for --mode bucketed; the
    kernel modes stop instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["run", "fluid_3d_cpu", "--frames", "1", "--substeps", "1", "--window", "auto"]
    for mode in ([], ["--mode", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA device visible"):
            main(args + mode)
    main(args + ["--mode", "bucketed"])
    out = capsys.readouterr().out
    assert "scene=fluid_3d_cpu N=32768 grid=(32, 32, 32) mode=bucketed device=cpu" in out
    assert "air-window engine: wy=" in out
    assert any(line.startswith("lost: 0 ") for line in out.splitlines())
    main(["info"])
    assert "torch " in capsys.readouterr().out
