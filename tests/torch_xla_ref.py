"""The JAX package's XLA bucket engine (`mpm_tpu.ops.bucketed.substep`) run
in a subprocess under XLA_FLAGS=--xla_cpu_max_isa=AVX, for the port's
bit-exact comparisons on the CPU.

Two rewrites of XLA on the CPU keep its engine from the port's last bit:
- it contracts `a * b + c` to fused multiply-adds (245,839 of 2^20 results
  differ from the unfused sum at the 16^3 K=8 scene). Without FMA
  instructions (`--xla_cpu_max_isa=AVX`) it cannot. XLA reads the flag when
  its backend starts, and tests/conftest.py starts it first, so the JAX
  half runs in a process of its own;
- under jit it computes the fixed-point decode's `x / f32(1e7)` as
  `x * (1 / f32(1e7))` (146,900 of 2^20 int32 values differ from the IEEE
  quotient), with or without the flag. The port keeps IEEE division, which
  is what the JAX source and its Pallas kernels write; a test that holds a
  fixed-point port result to XLA's decodes with `reciprocal_decode`;
- it folds the clamps' `x + n - CFL_EPS` (the CFL clamp's top, n = 2, and
  a rejected mover's, n = 1) to `x + (n - CFL_EPS)`, one ulp off the
  source's order at some x (1.9990001 for 1.999 at x = 1). The port keeps
  the source's order; a test whose state rejects moves (full cells) holds
  the port to XLA under `folded_tops`.

With both taken care of, the port's plain engine equals XLA's bit for bit
in float32, bf16 and fixed-point storage. The scene is the 16^3 K=8
fluid_3d of tests/test_fused.py and tests/test_sharded.py.

Run as a script it reads the initial states from an npz file, takes the
substeps and writes the results to another: `python torch_xla_ref.py N
IN.npz OUT.npz CASE...`."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np

FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")
# "full": float32 storage, with every slot of the grid's interior cells
# occupied (torch_shard_cases.full_state), and the benchmark pool's static
# EOS exponent 7 (multiplies in both engines): at the density of full cells
# the pressure leaves its floor, where XLA's CPU `pow` is not correctly
# rounded (1 ulp on some 700 of 2^20 values; the port's `fmath.pow_rn` is)
# and 978 of the 98,304 positions differ after 3 substeps with a run-time
# exponent: XLA's numerics, not the bucket passes
STORAGE = {"f32": {}, "bf16": {"storage_dtype": "bfloat16"}, "fixed": {"fixed_point": True},
           "full": {"eos_power_static": 7.0}}
SCENE = dict(grid_res=16, box=8.0, spacing=0.8)
# the "orbit" case's CLI flags: the orbit sphere moves every substep (one
# frame of one substep each), dt overridden, gravity flipped from frame 2
ORBIT_ARGS = dict(interact=[], orbit_sphere=True, fluid=["dt=0.15"], flip_gravity_at=2)
REPO = Path(__file__).resolve().parents[1]


def xla_substeps(states: dict, n: int) -> dict:
    """`n` substeps of the JAX XLA engine from each case's initial state
    (case -> numpy arrays by field, bf16 fields as float32), all computed
    without FMA in one subprocess; the results likewise. A case is a
    storage of STORAGE, or the f32 scene in the air window (arrays y in
    [0, 16) of a (16, 32, 16) domain, "windowed"), with a sphere
    interaction ("sphere"), tests/test_torch_bucketed.py's, or with the
    run-time surface of the JAX package's CLI ("orbit": substep i takes
    frame i's fluid and interactions under ORBIT_ARGS, through its
    `_apply_fluid_overrides` and `_parse_interactions`)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in.npz"), Path(tmp, "out.npz")
        np.savez(src, **{f"{c}.{f}": a for c, st in states.items() for f, a in st.items()})
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip(),
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        argv = [sys.executable, str(Path(__file__).resolve()), str(n), str(src), str(dst),
                *states]
        proc = subprocess.run(argv, env=env, cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"the XLA reference failed:\n{proc.stderr[-4000:]}")
        with np.load(dst) as out:
            return {c: {f: out[f"{c}.{f}"] for f in FIELDS} for c in states}


def state_arrays(b) -> dict:
    """A port BucketState as numpy arrays by field (bf16 as float32)."""
    return {f: getattr(b, f).float().numpy() if getattr(b, f).is_floating_point()
            else getattr(b, f).numpy() for f in FIELDS}


@contextmanager
def reciprocal_decode():
    """The port's fixed-point decode as XLA computes it under jit: a
    multiply by the float32 reciprocal of the multiplier."""
    import torch

    from mpm_tpu_torch.ops import fixed_point

    ieee = fixed_point.decode

    def decode(x, mult, dtype=torch.float32):
        inv = np.float32(1.0) / np.float32(mult)
        return x.to(dtype) * torch.tensor(float(inv), dtype=dtype, device=x.device)

    fixed_point.decode = decode
    try:
        yield
    finally:
        fixed_point.decode = ieee


@contextmanager
def reassociated_gather():
    """The oracle's G2P tap value w * decode(x) as XLA computes it in 3D
    under jit: the decode's multiply by the reciprocal of the multiplier
    moved onto the weight, x * (w * (1 / mult)). Float grids unchanged."""
    from mpm_tpu_torch.ops import reference

    own = reference.weighted_decode

    def weighted_decode(w, x, config):
        if not config.fixed_point:
            return own(w, x, config)
        inv = np.float32(1.0) / np.float32(config.fixed_point_mult)
        return x.to(w.dtype) * (w * float(inv))

    reference.weighted_decode = weighted_decode
    try:
        yield
    finally:
        reference.weighted_decode = own


@contextmanager
def folded_tops():
    """The port's clamp tops as XLA computes them: x + (n - CFL_EPS)."""
    from mpm_tpu_torch.ops import bucketed

    own = bucketed.cell_top
    bucketed.cell_top = lambda x, n: x + (n - bucketed.CFL_EPS)
    try:
        yield
    finally:
        bucketed.cell_top = own


def assert_equal_to_xla(got, want: dict) -> None:
    """Every field of a port BucketState equals the XLA result bit for bit."""
    for f in FIELDS:
        g = getattr(got, f)
        g = g.float().numpy() if g.is_floating_point() else g.numpy()
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      want[f].view(np.int32) if want[f].dtype == np.float32
                                      else want[f], err_msg=f)


def _main(argv) -> None:
    import argparse

    import jax
    import jax.numpy as jnp

    from mpm_tpu.__main__ import _apply_fluid_overrides, _parse_interactions
    from mpm_tpu.models.scenes import fluid_3d
    from mpm_tpu.ops import bucketed as jb
    from mpm_tpu.ops.interact import Interaction
    from mpm_tpu.ops.window import window_config

    n, src, dst, cases = int(argv[0]), argv[1], argv[2], argv[3:]
    j = fluid_3d(**SCENE)
    out = {}
    with np.load(src) as z:
        for case in cases:
            cfg = j.config.replace(bin_capacity=8, **STORAGE.get(case, {}))
            inter = ()
            if case == "windowed":
                cfg = window_config(cfg.replace(grid_res=(16, 32, 16)), 16)
            if case == "sphere":
                inter = (Interaction.sphere((8.0, 8.0, 8.0), radius=4.0, strength=0.5),)
            vc = jnp.bfloat16 if case == "bf16" else jnp.float32
            b = jb.BucketState(*(jnp.asarray(z[f"{case}.{f}"]).astype(vc) if f in ("vel", "C")
                                 else jnp.asarray(z[f"{case}.{f}"]) for f in FIELDS))
            if case == "orbit":
                args = argparse.Namespace(**ORBIT_ARGS)
                fluid_fn = _apply_fluid_overrides(args, j.fluid)[1]
                inter_fn = _parse_interactions(args, cfg)[1]
                step = jax.jit(lambda b, f, it, cfg=cfg: jb.substep(b, cfg, f, it))
                for i in range(n):
                    b = step(b, fluid_fn(i), inter_fn(i))
            else:
                step = jax.jit(lambda b, f, cfg=cfg, inter=inter: jb.substep(b, cfg, f, inter))
                for _ in range(n):
                    b = step(b, j.fluid)
            for f in FIELDS:
                a = getattr(b, f)
                out[f"{case}.{f}"] = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                                else a)
    np.savez(dst, **out)


if __name__ == "__main__":
    _main(sys.argv[1:])
