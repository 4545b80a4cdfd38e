"""Per-phase substep profile at the benchmark config on one card: the
port of scripts/profile_substep.py, the headless analogue of the
reference's per-phase prints (MLSMPM3DFluidMultithread.cs:185-219).

    python -m mpm_tpu_torch.utils.profile_substep [n_particles] [settle_substeps] [--trace PATH]

It steps `benchmark_scene(n)` (1M by default; K=8, bf16 vel/C) for
`settle` substeps (150) through make_step(mode="cuda"), then times through
`PhaseTimer` (host clock, each call fenced) 20 calls each of:
- FULL substep: make_step(mode="cuda"), kernels P and F;
- P (p2g_update) and F (g2p_migrate) alone, the main path's two kernels;
- the per-pass phases, on a float32 copy of the settled state (kernels A,
  B, D and E take float32 vel/C only, as the JAX package's do): P2G with A +
  B (`planes.p2g_planes`), the grid update (plain), D (`planes.g2p_planes`),
  the advection tail (plain) and the migration E (`migrate_planes`, whole:
  its z, y and x phases are one launch).
It prints each phase's line, then the per-pass phases' sum and P + F beside
the full substep, as the JAX script does. `--trace PATH` times the phases
under the torch profiler and writes its chrome trace: each call in its
`mpm.phase.<name>` span over the kernels it launched (the profiler's host
cost is then in the times). Needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.scenes import benchmark_scene
from ..ops import bucketed
from ..ops.bucketed import advect_tail
from ..ops.cuda import g2p_migrate as kf
from ..ops.cuda import p2g_update as kp
from ..ops.cuda import planes
from ..ops.cuda.migrate_planes import migrate_planes
from ..ops.grid import update_grid
from ..ops.step import make_step
from .timing import PhaseTimer, end_trace, fence, start_trace

ITERS = 20
PER_PASS = ("p2g (A+B)", "grid update", "g2p (D)", "advect tail", "migrate (E: z, y, x)")


def time_phases(state, config, fluid, pt: PhaseTimer, iters: int = ITERS):
    """`iters` calls of each phase of `state`'s substep into `pt` (the full
    substep chained on its own output); returns the state after the full
    substeps."""
    step = make_step(config, mode="cuda", substeps=1)
    for _ in range(iters):
        state = pt.measure("FULL substep", step, state, fluid)

    grid = kp.p2g_update(state, config, fluid)
    for _ in range(iters):
        pt.measure("P (p2g_update)", kp.p2g_update, state, config, fluid)
    for _ in range(iters):
        pt.measure("F (g2p_migrate)", kf.g2p_migrate, state, grid, config, fluid)

    cfg32 = config.replace(storage_dtype="float32")
    s32 = state.replace(vel=state.vel.float(), C=state.C.float())
    g32 = planes.p2g_planes(s32, cfg32, fluid)
    gvel = update_grid(g32, cfg32, fluid)
    vel, Cm = planes.g2p_planes(s32, gvel, cfg32)
    tail = advect_tail(s32, vel, Cm, cfg32, fluid)
    phases = [("p2g (A+B)", planes.p2g_planes, (s32, cfg32, fluid)),
              ("grid update", update_grid, (g32, cfg32, fluid)),
              ("g2p (D)", planes.g2p_planes, (s32, gvel, cfg32)),
              ("advect tail", advect_tail, (s32, vel, Cm, cfg32, fluid)),
              ("migrate (E: z, y, x)", migrate_planes, (tail, cfg32))]
    for label, fn, fargs in phases:
        fence(fn(*fargs))
        for _ in range(iters):
            pt.measure(label, fn, *fargs)
    return state


def phase_sum(pt: PhaseTimer) -> str:
    """The per-pass phases' sum and P + F beside the full substep, ms a call."""
    def ms(*names):
        return sum(pt.totals[n] / pt.counts[n] for n in names) * 1e3

    return (f"# phase sum {ms(*PER_PASS):.3f} ms (per-pass, float32 vel/C) vs full substep "
            f"{ms('FULL substep'):.3f} ms; P + F {ms('P (p2g_update)', 'F (g2p_migrate)'):.3f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_particles", nargs="?", type=int, default=1_000_000)
    ap.add_argument("settle", nargs="?", type=int, default=150)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="profile the timed phases and write the chrome trace, with each "
                         "call's mpm.phase.* span, here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_substep: no CUDA device visible")
    scene = benchmark_scene(args.n_particles)
    config, fluid = scene.config, scene.fluid
    n, k = scene.state.num_particles, config.bin_capacity
    slots = k * config.num_cells
    print(f"# {n} particles, grid {config.grid_res}, K={k} -> {slots} slots, device "
          f"{torch.cuda.get_device_name()}")

    state = bucketed.from_simstate(scene.state, config)
    step = make_step(config, mode="cuda", substeps=1)
    t0 = time.perf_counter()
    for _ in range(args.settle):
        state = step(state, fluid)
    fence(state)
    print(f"# settle {args.settle} substeps: {time.perf_counter() - t0:.1f}s, "
          f"lost={int(state.lost)}", flush=True)

    pt = PhaseTimer()
    prof = start_trace(args.trace, "cuda")
    time_phases(state, config, fluid, pt)
    end_trace(prof, args.trace)
    full_ms = pt.totals["FULL substep"] / ITERS * 1e3
    print(f"# full substep: {full_ms:.3f} ms -> {n / (full_ms / 1e3) / 1e6:.1f} M "
          f"particle-steps/s, {full_ms * 1e6 / slots:.2f} ns/slot", flush=True)
    print(pt.report(), flush=True)
    print(phase_sum(pt))


if __name__ == "__main__":
    main()
