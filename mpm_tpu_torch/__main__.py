"""Command-line entry of the PyTorch port.

    python -m mpm_tpu_torch run fluid_3d --frames 60 --window auto
    python -m mpm_tpu_torch render fluid_3d --frames 30 --out frames
    python -m mpm_tpu_torch info

`run` steps a scene headless and prints per-run stats and the bucket
counters; `render` also draws every frame with the SSFR renderer and writes
it as a PNG. Modes "auto" and "cuda" run the CUDA kernels and stop when no
CUDA device is visible; mode "bucketed" runs the plain PyTorch engine, on
the card when one is visible, else on the CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mpm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="step a scene headless")
    render = sub.add_parser("render", help="step a scene and write PNG frames")
    for q in (run, render):
        q.add_argument("scene", nargs="?", default="fluid_3d")
        q.add_argument("--frames", type=int, default=30)
        q.add_argument("--substeps", type=int, default=None,
                       help="substeps per frame (default: the scene's)")
        q.add_argument("--mode", default="auto", choices=["auto", "bucketed", "cuda"],
                       help="auto/cuda = the CUDA kernels (needs a card); bucketed = "
                       "the plain PyTorch engine (the CPU when no card is visible)")
        q.add_argument("--window", default="off", choices=["off", "auto"],
                       help="auto = air-window engine (ops/window.py): arrays "
                       "track the occupied y-range; identical physics")
    render.add_argument("--out", default="mpm_frames", help="directory of the PNGs")
    render.add_argument("--width", type=int, default=960)
    render.add_argument("--height", type=int, default=540)
    render.add_argument("--render-quality", default="cell", choices=["cell", "particle"],
                        help="cell = each cell's nearest particle; particle = every "
                        "live particle")
    render.add_argument("--max-radius-px", type=int, default=6,
                        help="splat disc radius cap in pixels")
    render.add_argument("--sphere-radius", type=float, default=1.0)
    render.add_argument("--crop", default="auto", choices=["auto", "off"],
                        help="auto = the dilation, blur and shade run on the "
                        "domain's projected rectangle only (the same frame)")
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


def _device(mode: str) -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda")
    if mode == "bucketed":
        return torch.device("cpu")
    raise SystemExit(f"no CUDA device visible: mode {mode!r} runs the CUDA "
                     "kernels; --mode bucketed runs the plain engine on the CPU")


def _print_counters(state) -> None:
    lost, deferred, cfl, ceil = (int(v) for v in (
        state.lost, state.deferred, state.cfl_clamped, state.ceiling))
    print(f"lost: {lost} deferred: {deferred} cfl-clamped: {cfl}"
          + (f" window-ceiling: {ceil}" if ceil else ""))


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernels in this process."""
    from .ops.cuda import g2p_migrate, p2g_update
    from .render import blur_kernel, extract_kernel

    return {"p2g_update": p2g_update.launches, "g2p_migrate": g2p_migrate.launches,
            "g2p_migrate_emit": g2p_migrate.emit_launches,
            "extract_cells": extract_kernel.launches, "blur_depth": blur_kernel.launches}


def cmd_run(args) -> None:
    from .models.scenes import get_scene
    from .utils.timing import FrameStats, fence

    device = _device(args.mode)
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
    _print_counters(state)
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")


def cmd_render(args) -> None:
    """The frame loop of mpm_tpu/__main__.py cmd_render, bucket path: with
    --window auto the air-window engine steps and render_frame_buckets
    draws (kernel X); with --window off, quality cell and a kernel mode,
    make_full_frame_step runs the substeps with kernel F's splat emission
    and draws from its splats. Frames leave the device as u8, and PNG
    writes overlap the next frames on worker threads."""
    from .models.scenes import get_scene
    from .render import (Camera, RenderConfig, SSFRParams, background_for_view,
                         default_view, domain_crop, frame_to_u8, make_full_frame_step,
                         render_frame_buckets, write_png)
    from .utils.timing import FrameStats

    device = _device(args.mode)
    scene = get_scene(args.scene, device=device)
    if scene.config.dim != 3:
        raise SystemExit("render draws 3D scenes; the 2D renderer is still to port")
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    cam = Camera(width=args.width, height=args.height)
    rc = RenderConfig(camera=cam, ssfr=SSFRParams(particle_sphere_radius=args.sphere_radius),
                      quality=args.render_quality, max_radius_px=args.max_radius_px)
    view = default_view(scene.config.grid_res)
    if args.crop == "auto":
        rc = domain_crop(rc, scene.config, view)
        if rc.crop:
            y0, x0, ch, cw = rc.crop
            print(f"fluid crop: {cw}x{ch}+{x0}+{y0} "
                  f"({cw * ch / (cam.width * cam.height):.0%} of frame)")
    step, state, win = build(scene, args.mode, args.window, substeps)
    print(f"scene={scene.name} N={n} grid={scene.config.grid_res} mode={args.mode} "
          f"window={args.window} {cam.width}x{cam.height} quality={rc.quality} "
          f"device={device}")
    bg = background_for_view(rc, view, device)
    full_frame = None
    if args.mode != "bucketed" and win is None and rc.quality == "cell":
        full_frame = make_full_frame_step(scene.config, rc, substeps)
    grid_res = (win.config if win is not None else scene.config).grid_res

    def frame(state):
        if full_frame is not None:
            return full_frame(state, scene.fluid, (), view, bg)
        state = step(state, scene.fluid, ())
        return state, frame_to_u8(render_frame_buckets(state, view, rc, bg=bg,
                                                       grid_res=grid_res))

    os.makedirs(args.out, exist_ok=True)
    stats = FrameStats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = []
        for i in range(args.frames):
            state, img = frame(state)
            host = img.cpu().numpy()  # waits for the frame
            pending.append(pool.submit(write_png,
                                       os.path.join(args.out, f"frame_{i:05d}.png"), host))
            if len(pending) > 4:
                pending.pop(0).result()
            stats.tick()
            if i == 0:
                print(f"first frame: {time.perf_counter() - t0:.1f}s (builds the CUDA "
                      "kernels on first use)")
        for f in pending:
            f.result()
    s = stats.stats
    print(f"{args.frames} frames -> {args.out} (avg {s['avg_ms']:.2f} ms/frame after the "
          f"first, min {s['min_ms']:.2f} max {s['max_ms']:.2f}, incl. PNG writes) -> "
          f"{n * substeps * s['fps'] / 1e6:.1f}M particle-steps/s with render on {device}")
    _print_counters(state)
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))


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
    {"run": cmd_run, "render": cmd_render, "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])
