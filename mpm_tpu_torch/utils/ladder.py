"""The BASELINE ladder on one card: the port of scripts/ladder.py's rows
3, 3a, 4, 4a, dam and dama (scripts/ladder.py:44-52, 135-158), grids as
BASELINE.md gives them, air included.

    python -m mpm_tpu_torch.utils.ladder 3      # 250k on a true 64^3
    python -m mpm_tpu_torch.utils.ladder 4      # 4M on a true 128^3
    python -m mpm_tpu_torch.utils.ladder 3a     # the same through the air window
    python -m mpm_tpu_torch.utils.ladder 4a
    python -m mpm_tpu_torch.utils.ladder dam    # the 1M dam-break mid-collapse
    python -m mpm_tpu_torch.utils.ladder dama   # the dam-break through the air window

The plain rows step `make_step(mode="cuda", substeps=10)`, the "a" rows
`YWindow(mode="cuda", substeps=10)` on the true grid (the same physics;
their time includes each chunk's occupancy poll and any resize): 15 settle
chunks of 10 substeps (6 for the dam-break: substeps 60-160 catch the
collapse's churn), then 3 windows of 100 substeps, each fenced by a device
synchronise. The RESULT line gives the best window's ms a substep,
particle-steps a second, lost, deferred (plain rows) or wy, resizes and
ceiling hits ("a" rows), and ns a slot. Needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.scenes import benchmark_dam_break, benchmark_scene
from ..ops import bucketed
from ..ops.cuda.step import route
from ..ops.step import make_step
from ..ops.window import YWindow
from .timing import fenced_windows

CONFIGS = {"3": (250_000, (64, 64, 64)), "4": (4_000_000, (128, 128, 128))}
ROWS = ("3", "3a", "4", "4a", "dam", "dama")
CHUNK = 10  # substeps a step call
WINDOWS, ITERS = 3, 100  # timed windows, substeps a window


def _scene(which: str, dev):
    """(scene, settle chunks) of a row."""
    if which.startswith("dam"):
        return benchmark_dam_break(1_000_000, device=dev), 6
    n, grid = CONFIGS[which.rstrip("a")]
    return benchmark_scene(n, grid_res=grid, device=dev), 15


def run_row(which: str, dev, log=print) -> dict:
    """One ladder row; returns the RESULT line's fields (and `finite`)."""
    scene, settle_chunks = _scene(which, dev)
    config, fluid = scene.config, scene.fluid
    n = scene.state.num_particles
    k = config.bin_capacity
    windowed = which.endswith("a")
    name = torch.cuda.get_device_name(dev)
    if windowed:
        win = YWindow(config, mode="cuda", substeps=CHUNK)
        state = win.init(scene.state)
        step, cfg = win.step, win.config
        log(f"# {n} particles, TRUE grid {config.grid_res}, auto window wy={win.wy} -> "
            f"{k * cfg.num_cells} slots ({k * cfg.num_cells / n:.2f}/particle), device {name}")
    else:
        state = bucketed.from_simstate(scene.state, config)
        step = make_step(config, mode="cuda", substeps=CHUNK)
        slots = k * config.num_cells
        log(f"# {n} particles, grid {config.grid_res}, K={k} -> {slots} slots "
            f"({slots / n:.2f}/particle), engine {route(config, per_pass=False)}, device {name}")
    del scene
    t0 = time.perf_counter()
    for _ in range(settle_chunks):
        state = step(state, fluid)
    extra = f" wy={win.wy} resizes={win.resizes}" if windowed else \
        f" deferred={int(state.deferred)}"
    log(f"# advance {settle_chunks * CHUNK} substeps: {time.perf_counter() - t0:.1f}s "
        f"lost={int(state.lost)}{extra}")
    state, times = fenced_windows(step, state, fluid, ITERS // CHUNK, WINDOWS)
    best, iters = min(times), ITERS
    for w, dt in enumerate(times):
        log(f"# window {w}: {iters} substeps in {dt:.3f}s" + (f" wy={win.wy}" if windowed else ""))
    ms = best / iters * 1e3
    res = {"row": which, "particles": n, "grid": list(config.grid_res), "K": k,
           "ms_per_substep": ms, "particle_steps_per_s": n * iters / best,
           "window_s": times, "lost": int(state.lost),
           "finite": bool(torch.isfinite(state.pos).all())}
    if windowed:
        slots = k * win.config.num_cells
        res.update(wy=win.wy, resizes=win.resizes, ceiling_hits=int(state.ceiling),
                   interference=win.interference)
        tail = (f"lost={res['lost']} wy={win.wy} resizes={win.resizes} "
                f"ceiling-hits={res['ceiling_hits']} ({ms * 1e6 / slots:.2f} ns/slot at the "
                "final window)")
    else:
        res.update(deferred=int(state.deferred))
        tail = f"lost={res['lost']} deferred={res['deferred']}  ({ms * 1e6 / slots:.2f} ns/slot)"
    res["ns_per_slot"] = ms * 1e6 / slots
    log(f"RESULT {ms:.4f} ms/substep  {n * iters / best / 1e6:.1f} M ps/s  {tail}")
    if not res["finite"]:
        raise AssertionError(f"ladder row {which}: non-finite positions")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("row", nargs="?", default="3", choices=ROWS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ladder: no CUDA device visible")
    run_row(args.row, torch.device("cuda", 0))


if __name__ == "__main__":
    main()
