"""Any number of interactions: kernel F's and sim2d's tails read the
spheres from a device array (ops/interact.interaction_rows), so neither the
port nor the JAX package caps them. On the CPU: the plain F chain and the
plain 2D substep (the wrappers' plain versions through make_step(mode=
"cuda"), which the kernels equal bit for bit on the card) with 12 spheres
against the JAX XLA bucket engine run without FMA, and the CLI taking nine
--interact flags.

Bars: bit for bit against the XLA engine, every field and counter; the
spheres in list order.
"""

import numpy as np
import pytest
import torch

from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_3d
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.ops.interact import Interaction, interaction_rows
from mpm_tpu_torch.ops.step import make_step

from torch_jax_cases import run_cases

torch.set_num_threads(2)

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def spheres(dim: int, n: int = 12, seed: int = 3) -> tuple:
    """n spheres over the scenes' fluid, both kinds, the sixth inactive."""
    rng = np.random.default_rng(seed)
    hi = 12.0 if dim == 3 else 40.0
    out = []
    for i in range(n):
        c = rng.uniform(4.0, hi, dim).astype(np.float32).tolist()
        make = Interaction.sphere if i % 2 else Interaction.mouse
        out.append(make(c, radius=float(rng.uniform(2.0, 6.0)),
                        strength=float(rng.uniform(0.1, 0.6)), active=0.0 if i == 5 else 1.0))
    return tuple(out)


def _case(dim):
    if dim == 3:
        sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device="cpu")
        over, name = {"bin_capacity": 8}, "fluid_3d"
        kw = dict(grid_res=16, box=8.0, spacing=0.8)
    else:
        sc = dam_break_2d(device="cpu")
        over, name, kw = {"bin_capacity": 8}, "dam_break_2d", {}
    cfg = sc.config.replace(**over)
    return sc, cfg, tb.from_simstate(sc.state, cfg), dict(scene=name, scene_kw=kw, config=over)


@pytest.fixture(scope="module")
def xla():
    cases, states = {}, {}
    for dim in (2, 3):
        sc, cfg, b, spec = _case(dim)
        rows = interaction_rows(spheres(dim), dim, "cpu").tolist()
        cases[f"d{dim}"] = dict(spec, engine="bucketed", substeps=3, spheres=rows)
        states[f"d{dim}"] = {f: getattr(b, f).numpy() for f in FIELDS}
    return run_cases(cases, states)


@pytest.mark.parametrize("dim", [2, 3])
def test_twelve_spheres_match_jax_xla(xla, dim):
    sc, cfg, b, _ = _case(dim)
    inter = spheres(dim)
    got = make_step(cfg, mode="cuda", substeps=3)(b, sc.fluid, inter)
    free = make_step(cfg, mode="cuda", substeps=3)(b, sc.fluid)
    assert not torch.equal(got.pos, free.pos)  # the spheres push
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), xla[f"d{dim}"][f], err_msg=f)


def test_interaction_rows_layout():
    """[n, D + 4] float32 in list order, each row the sphere's values();
    none for no sphere; a centre of the wrong dimension raises."""
    inter = spheres(3, n=9)
    rows = interaction_rows(inter, 3, "cpu")
    assert rows.shape == (9, 7) and rows.dtype == torch.float32
    assert rows.tolist() == [list(np.float32(it.values())) for it in inter]
    assert interaction_rows((), 3, "cpu") is None
    with pytest.raises(ValueError, match="3D interactions"):
        interaction_rows(spheres(2, n=1), 3, "cpu")


def test_cli_takes_nine_spheres(capsys):
    """`run` with nine --interact flags and the orbit sphere: ten
    interactions, rc 0, every particle kept."""
    args = ["run", "dam_break_2d", "--device", "cpu", "--mode", "bucketed", "--frames", "2",
            "--orbit-sphere"]
    for i in range(9):
        args += ["--interact", f"sphere={10 + 5 * i},20,4,0.5"]
    main(args)
    out = capsys.readouterr().out
    assert "interactions=10" in out and "lost: 0" in out
