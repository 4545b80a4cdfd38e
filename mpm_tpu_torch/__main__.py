"""Command-line entry of the PyTorch port.

    python -m mpm_tpu_torch run fluid_3d --frames 60 --window auto
    python -m mpm_tpu_torch info

`run` steps a scene headless and prints per-run stats and the bucket
counters. Modes "auto" and "cuda" run the CUDA kernels and stop when no CUDA
device is visible; mode "bucketed" runs the plain PyTorch engine, on the
card when one is visible, else on the CPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mpm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="step a scene headless")
    run.add_argument("scene", nargs="?", default="fluid_3d")
    run.add_argument("--frames", type=int, default=30)
    run.add_argument("--substeps", type=int, default=None,
                     help="substeps per frame (default: the scene's)")
    run.add_argument("--mode", default="auto", choices=["auto", "bucketed", "cuda"],
                     help="auto/cuda = the CUDA kernels (needs a card); bucketed = "
                     "the plain PyTorch engine (the CPU when no card is visible)")
    run.add_argument("--window", default="off", choices=["off", "auto"],
                     help="auto = air-window engine (ops/window.py): arrays "
                     "track the occupied y-range; identical physics")
    sub.add_parser("info", help="print the device")
    return p


def nvidia_smi_power() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def build(scene, mode: str, window: str, substeps: int | None):
    """(step, state, win) for a scene whose state is on its device: the
    air-window engine when window == "auto", else the plain frame step."""
    from .ops import bucketed
    from .ops.step import make_step
    from .ops.window import YWindow

    n = substeps or scene.config.substeps
    if window == "auto":
        win = YWindow(scene.config, mode=mode, substeps=n)
        return win.step, win.init(scene.state), win
    step = make_step(scene.config, mode=mode, substeps=n)
    return step, bucketed.from_simstate(scene.state, scene.config), None


def cmd_run(args) -> None:
    from .models.scenes import get_scene
    from .utils.timing import FrameStats, fence

    if torch.cuda.is_available():
        device = torch.device("cuda")
    elif args.mode == "bucketed":
        device = torch.device("cpu")
    else:
        raise SystemExit(f"no CUDA device visible: mode {args.mode!r} runs the CUDA "
                         "kernels; --mode bucketed runs the plain engine on the CPU")
    scene = get_scene(args.scene, device=device)
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    step, state, win = build(scene, args.mode, args.window, substeps)
    print(f"scene={scene.name} N={n} grid={scene.config.grid_res} "
          f"mode={args.mode} device={device}")
    if win is not None:
        print(f"air-window engine: wy={win.wy} of ny={scene.config.grid_res[1]}")

    t0 = time.perf_counter()
    state = step(state, scene.fluid, ())
    fence(state)
    print(f"first frame: {time.perf_counter() - t0:.1f}s (builds the CUDA kernels "
          "on first use)")

    stats = FrameStats()
    stats.tick()
    for _ in range(args.frames):
        state = step(state, scene.fluid, ())
        fence(state)
        stats.tick()
    s = stats.stats
    pps = n * substeps * s["fps"]
    print(f"frames={args.frames} avg={s['avg_ms']:.2f}ms min={s['min_ms']:.2f} "
          f"max={s['max_ms']:.2f} fps={s['fps']:.1f} -> {pps / 1e6:.1f}M "
          f"particle-steps/s on {device}")
    lost, deferred, cfl, ceil = (int(v) for v in (
        state.lost, state.deferred, state.cfl_clamped, state.ceiling))
    print(f"lost: {lost} deferred: {deferred} cfl-clamped: {cfl}"
          + (f" window-ceiling: {ceil}" if ceil else ""))
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")


def cmd_info(args) -> None:
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        print("no CUDA device visible")
        return
    for i in range(torch.cuda.device_count()):
        print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
    print(f"nvidia-smi name, power.limit: {nvidia_smi_power()}")


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    {"run": cmd_run, "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])
