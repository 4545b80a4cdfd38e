"""Kernels P and F (and the 2D pair) across slot counts on one card: above
64 slots a cell the bucket kernels walk a cell's slots a chunk of 64 at a
time (csrc/bucket_kernels.cuh, WIDE); at 64 and below they run one 32-bit
or 64-bit mask.

For each K it packs a dense scene and takes 2 substeps through
make_step(mode="cuda") (so vel and C are not zero), the launch counts set
to 0 just before and read just after, the state bit-equal to 2 plain
substeps; then it holds each kernel against its plain version on that
state and times both with CUDA events in turns (plain, kernel, kernel,
plain), beside the roofline bound of the same call's work
(utils/roofline.py). Each row names its particles: the packing drops those
beyond K in a cell.
- 3D: fluid_3d on a 32^3 grid, a 16^3 box at spacing 0.24 (64 to 125
  particles a fluid cell), rest density 80, so the
  pressure stays near its floor; K = 200 at spacing 0.19 (125 to 216 a
  cell), rest density 170;
- 3D, the same particles at every K >= 64 ("fit"): the box at spacing 0.3
  (up to 64 a cell), rest density 40, so that rows of different K differ
  in their slots alone;
- 2D (K = 72): dam_break_2d on a 128^2 grid, a 32^2 box at spacing 0.12
  (64 to 81 a cell), rest density 70.
With --pool, also P and F on the settled 1M pool window (K=8, bf16; the
main path's shapes), as chip_smoke times them.

    python mpm_tpu_torch/utils/wide_k.py [--ks 64,72,128] [--pool] [--root CHECKOUT]

--root: the checkout whose mpm_tpu_torch is timed (default: the one holding
this file); run it with two checkouts in turns to compare them (the
functions here import mpm_tpu_torch from --root). A K the
checkout's kernels refuse is reported as refused. Prints one JSON line a
row and the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# the dense scenes' (spacing, rest density): 3D below K = 200 and at 200,
# 3D at most 64 a cell, 2D
DENSE_3D = {"default": (0.24, 80.0), 200: (0.19, 170.0), "fit": (0.3, 40.0)}
DENSE_2D = (0.12, 70.0)
WIDE_2D_K = 72


def dense_kwargs(dim: int, k: int, grid: int | None = None,
                 fit: bool = False) -> tuple[dict, dict]:
    """(scene kwargs, FluidParams.create kwargs) of the dense scene of `dim`
    axes at K = k: 3D fluid_3d, a box half the grid wide (32^3 by default;
    `fit`: at most 64 particles a cell); 2D dam_break_2d, a box a quarter of
    it (128^2), each scene's own fluid but for the rest density."""
    if dim == 3:
        grid = grid or 32
        spacing, rho = DENSE_3D["fit"] if fit else DENSE_3D.get(k, DENSE_3D["default"])
        return (dict(grid_res=grid, box=grid / 2, spacing=spacing),
                dict(dim=3, eos_stiffness=1.0, eos_power=7.0, rest_density=rho))
    grid = grid or 128
    spacing, rho = DENSE_2D
    return (dict(grid_res=grid, box=grid / 4, spacing=spacing),
            dict(dim=2, dt=0.2, gravity=(0.0, 0.3), eos_stiffness=10.0, eos_power=7.0,
                 rest_density=rho))


def dense_scene(dim: int, k: int, dev, grid: int | None = None, warm: int = 2,
                fit: bool = False):
    """(config, fluid, state): the dense scene (dense_kwargs) packed at K = k
    after `warm` plain substeps."""
    from mpm_tpu_torch.core.params import FluidParams
    from mpm_tpu_torch.models.scenes import dam_break_2d, fluid_3d
    from mpm_tpu_torch.ops import bucketed

    scene_kw, fluid_kw = dense_kwargs(dim, k, grid, fit)
    sc = (fluid_3d if dim == 3 else dam_break_2d)(device=dev, **scene_kw)
    fluid = FluidParams.create(**fluid_kw)
    config = sc.config.replace(bin_capacity=k)
    state = bucketed.from_simstate(sc.state, config)
    for _ in range(warm):
        state = bucketed.substep(state, config, fluid)
    return config, fluid, state


def main_path(config, fluid, state, substeps: int = 2):
    """`substeps` substeps through make_step(mode="cuda"), the launch counts
    set to 0 just before and read just after: (state, {kernel: launches},
    largest difference from as many plain substeps)."""
    import torch

    from mpm_tpu_torch.__main__ import kernel_launches, reset_kernel_launches
    from mpm_tpu_torch.ops import bucketed
    from mpm_tpu_torch.ops.step import make_step

    step = make_step(config, mode="cuda", substeps=substeps)
    torch.cuda.synchronize()
    reset_kernel_launches()
    out = step(state, fluid)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_launches().items() if v}
    want = state
    for _ in range(substeps):
        want = bucketed.substep(want, config, fluid)
    return out, launched, _max_err(out, want)


def _scene_text(label: str, config, state) -> str:
    """The row's scene: its particles, fullest cell, and those the packing
    dropped."""
    fill = int((state.mass > 0).sum(0).max())
    return (f"{label} {config.grid_res} K={config.bin_capacity} f32, "
            f"{int((state.mass > 0).sum())} particles (fullest cell {fill}, "
            f"{int(state.lost)} dropped by the packing)")


def _max_err(got, want) -> float:
    """Largest |difference| over the fields of two states or grids."""
    import torch

    if isinstance(got, torch.Tensor):
        return float((got.float() - want.float()).abs().max())
    fields = ("mom", "mass") if hasattr(got, "mom") else ("pos", "vel", "C", "mass", "ids")
    err = max(float((getattr(got, f).float() - getattr(want, f).float()).abs().max())
              for f in fields)
    if not hasattr(got, "mom"):
        for f in ("lost", "cfl_clamped", "deferred", "ceiling"):
            if int(getattr(got, f)) != int(getattr(want, f)):
                return float("inf")
    return err


def _row(name, k, shape, kern, plain, work, launches: int, path_err: float):
    from mpm_tpu_torch.utils.roofline import bound_ms
    from mpm_tpu_torch.utils.timing import cuda_time_ms

    err = max(_max_err(kern(), plain()), path_err)
    p1 = cuda_time_ms(plain, iters=3)
    k1 = cuda_time_ms(kern, iters=50)
    k2 = cuda_time_ms(kern, iters=50)
    p2 = cuda_time_ms(plain, iters=3)
    bound, by = bound_ms(*work)
    return {"name": name, "K": k, "shape": shape, "launches": launches, "max_abs_err": err,
            "ms": [k1, k2], "plain_ms": [p1, p2], "bound_ms": bound, "bound_by": by,
            "bytes": work[0], "ops": work[1]}


def rows_3d(k: int, dev, fit: bool = False) -> list[dict]:
    """P and F at K = k on the dense 3D scene (`fit`: the one of at most 64
    a cell), its 2 substeps of make_step(mode="cuda") first."""
    from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
    from mpm_tpu_torch.ops.cuda import p2g_update as kp
    from mpm_tpu_torch.utils import roofline

    config, fluid, state = dense_scene(3, k, dev, warm=0, fit=fit)
    shape = _scene_text("fit fluid_3d" if fit else "dense fluid_3d", config, state)
    state, launched, path_err = main_path(config, fluid, state)
    grid = kp.p2g_update_plain(state, config, fluid)
    return [_row("p2g_update", k, shape, lambda: kp.p2g_update(state, config, fluid),
                 lambda: kp.p2g_update_plain(state, config, fluid),
                 roofline.p2g_update_work(state, config), launched.get("p2g_update", 0),
                 path_err),
            _row("g2p_migrate", k, shape, lambda: kf.g2p_migrate(state, grid, config, fluid),
                 lambda: kf.g2p_migrate_plain(state, grid, config, fluid),
                 roofline.g2p_migrate_work(state, config), launched.get("g2p_migrate", 0),
                 path_err)]


def rows_2d(k: int, dev) -> list[dict]:
    """sim2d and migrate2d at K = k on the dense 2D scene, its 2 substeps of
    make_step(mode="cuda") first."""
    from mpm_tpu_torch.ops.cuda import substep2d as k2d
    from mpm_tpu_torch.utils import roofline

    config, fluid, state = dense_scene(2, k, dev, warm=0)
    shape = _scene_text("dense dam_break_2d", config, state)
    state, launched, path_err = main_path(config, fluid, state)
    moved = k2d.sim2d_plain(state, config, fluid)
    return [_row("sim2d", k, shape, lambda: k2d.sim2d(state, config, fluid),
                 lambda: k2d.sim2d_plain(state, config, fluid),
                 roofline.sim2d_work(state, config), launched.get("sim2d", 0), path_err),
            _row("migrate2d", k, shape, lambda: k2d.migrate2d(moved, config),
                 lambda: k2d.migrate2d_plain(moved, config),
                 roofline.migrate_work(moved, config), launched.get("migrate2d", 0), path_err)]


def rows_pool(dev) -> list[dict]:
    """P and F on the settled 1M pool window (K=8, bf16)."""
    from mpm_tpu_torch.models.scenes import benchmark_scene
    from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
    from mpm_tpu_torch.ops.cuda import p2g_update as kp
    from mpm_tpu_torch.utils import roofline
    from mpm_tpu_torch.utils.render_bench import N_POOL, pool_window, settle

    pool = benchmark_scene(N_POOL, device=dev)
    win = pool_window(pool)
    state = settle(win, win.init(pool.state), pool.fluid)
    cfg = win.config
    grid = kp.p2g_update_plain(state, cfg, pool.fluid)
    shape = f"settled pool window {cfg.grid_res} K=8 bf16"
    return [_row("p2g_update", 8, shape, lambda: kp.p2g_update(state, cfg, pool.fluid),
                 lambda: kp.p2g_update_plain(state, cfg, pool.fluid),
                 roofline.p2g_update_work(state, cfg), 0, 0.0),
            _row("g2p_migrate", 8, shape, lambda: kf.g2p_migrate(state, grid, cfg, pool.fluid),
                 lambda: kf.g2p_migrate_plain(state, grid, cfg, pool.fluid),
                 roofline.g2p_migrate_work(state, cfg), 0, 0.0)]


def wide_resources(logs: dict) -> list[str]:
    """ptxas's registers and spills of the WIDE instantiations (K > 64) and
    of the 64-bit ones beside them, from this process's build logs."""
    from mpm_tpu_torch.utils.kernel_resources import _demangle, ptxas_table

    out = []
    for src in ("p2g_update", "g2p_migrate", "substep2d"):
        rows = ptxas_table(logs.get(src, ""))
        for (_, regs, st, ld), pretty in zip(rows, _demangle([r[0] for r in rows])):
            if "unsigned long long" in pretty:
                kind = "wide" if "unsigned long long, true>" in pretty else "64-bit"
                entry = pretty[:pretty.find(">(") + 1] if ">(" in pretty else pretty
                out.append(f"{src} {entry.replace('void ', '')[:130]} [{kind}]: "
                           f"{regs} registers, spill stores {st} B, loads {ld} B")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="64,72,128")
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    sys.path[0] = str(Path(args.root).resolve())  # not this file's folder

    import torch

    import mpm_tpu_torch
    from mpm_tpu_torch.__main__ import nvidia_smi_power

    if not torch.cuda.is_available():
        raise SystemExit("wide_k needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"# {mpm_tpu_torch.__file__}; {nvidia_smi_power()}", flush=True)
    ks = [int(k) for k in args.ks.split(",") if k]  # --ks "": the pool alone
    jobs = [(3, k, fit) for fit in (False, True) for k in ks if k >= 64 or not fit]
    if WIDE_2D_K in ks:
        jobs.append((2, WIDE_2D_K, False))
    for dim, k, fit in jobs:
        try:
            rows = rows_3d(k, dev, fit) if dim == 3 else rows_2d(k, dev)
        except (NotImplementedError, RuntimeError) as e:
            print(json.dumps({"dim": dim, "K": k, "fit": fit, "refused": str(e)[:200]}),
                  flush=True)
            continue
        for r in rows:
            print(json.dumps(r), flush=True)
    if args.pool:
        for r in rows_pool(dev):
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
