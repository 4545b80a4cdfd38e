"""Command-line entry of the PyTorch port.

    python -m mpm_tpu_torch run fluid_3d --frames 60 --window auto
    MPM_PALLAS_OLD=1 python -m mpm_tpu_torch run fluid_3d
    python -m mpm_tpu_torch run fluid_3d_fixed_point
    python -m mpm_tpu_torch render fluid_3d --frames 30 --out frames
    python -m mpm_tpu_torch render fluid_3d --thickness-pass --cubemap DIR
    python -m mpm_tpu_torch render fluid_3d --render-mode velocity_spheres
    python -m mpm_tpu_torch render fluid_3d --sphere-render-ratio 0.5
    python -m mpm_tpu_torch run bench2d
    python -m mpm_tpu_torch render dam_break_2d --out frames
    python -m mpm_tpu_torch run fluid_3d_cpu --device cpu --mode bucketed
    python -m mpm_tpu_torch run fluid_3d --shards 4 --window auto
    python -m mpm_tpu_torch run fluid_3d_cpu --shards 2 --device cpu --mode bucketed
    python -m mpm_tpu_torch info

`run` steps a scene headless and prints per-run stats and the bucket
counters; `render` also draws every frame (3D scenes with the SSFR
renderer, 2D scenes with render/render2d.py) and writes it as a PNG. Both
run on the card (`--device cuda`, the default) and stop when none is
visible. Modes "auto" and "cuda" run the CUDA kernels (under
MPM_PALLAS_OLD=1 the per-pass kernels A, B, D and E, as the JAX package's
knob does); mode "bucketed" runs the plain PyTorch engine, and is the only
mode of `--device cpu`. `--shards N` runs the x-slab decomposition
(parallel/domain.py) over the first N visible cards, or N CPU slabs under
`--device cpu`.
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
                       help="auto/cuda = the CUDA kernels; bucketed = the plain "
                       "PyTorch engine")
        q.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda = the card (stops when none is visible); cpu = "
                       "the plain engine on the CPU, --mode bucketed only")
        q.add_argument("--window", default="off", choices=["off", "auto"],
                       help="auto = air-window engine (ops/window.py): arrays "
                       "track the occupied y-range; identical physics (3D only)")
        q.add_argument("--shards", type=int, default=0,
                       help="N > 0: x-slab decomposition over the first N visible "
                       "cards (N CPU slabs with --device cpu); 3D scenes")
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
    render.add_argument("--render-mode", default="default",
                        choices=["default", "velocity_spheres", "lit_spheres", "depth_debug",
                                 "none", "legacy_quad"],
                        help="legacy_quad is not ported (ROADMAP.md)")
    render.add_argument("--sphere-render-ratio", type=float, default=1.0,
                        help="below 1: render that share of the live particles as a "
                        "particle array (render_frame), the reference's LOD slider")
    render.add_argument("--thickness-pass", action="store_true",
                        help="per-pixel material thickness feeds Beer's law and the "
                        "refraction offset (the default keeps the reference's constant)")
    render.add_argument("--thickness-scale", type=float, default=0.35)
    render.add_argument("--cubemap", default=None, metavar="DIR",
                        help="6-face PNG cubemap for the reflections (*-1..6.png or "
                        "px/nx/py/ny/pz/nz.png)")
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


def build(scene, mode: str, window: str, substeps: int | None, mesh=None):
    """(step, state, win) for a scene whose state is on its device: the
    air-window engine when window == "auto" and the scene is 3D, else the
    plain frame step; over the slab mesh `mesh` when one is given."""
    from .ops import bucketed
    from .ops.step import make_step
    from .ops.window import YWindow

    n = substeps or scene.config.substeps
    if window == "auto" and scene.config.dim == 3:
        win = YWindow(scene.config, mode=mode, substeps=n, mesh=mesh)
        return win.step, win.init(scene.state), win
    b = bucketed.from_simstate(scene.state, scene.config)
    if mesh is not None:
        from .parallel.domain import make_sharded_bucket_step, shard_bucket_state

        return (make_sharded_bucket_step(scene.config, mesh, substeps=n, mode=mode),
                shard_bucket_state(b, scene.config, mesh), None)
    return make_step(scene.config, mode=mode, substeps=n), b, None


def _mesh(args, scene, device):
    """The slab mesh of --shards N (mpm_tpu/__main__.py:211-236), or None:
    the first N visible cards, or N CPU slabs under --device cpu. Refuses 2D
    scenes and slabs thinner than 2 planes."""
    from .parallel.domain import SlabMesh

    n = args.shards
    if not n:
        return None
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--shards {n}: only {torch.cuda.device_count()} device(s) visible "
                         f"(--device cpu --mode bucketed runs {n} CPU slabs)")
    if scene.config.dim != 3:
        raise SystemExit("--shards requires a 3D scene on the bucket path")
    nx = scene.config.grid_res[0]
    if n < 1 or nx % n or nx // n < 2:
        raise SystemExit(f"--shards {n} must divide grid x={nx} into slabs of >= 2 planes")
    devices = ([torch.device("cuda", i) for i in range(n)] if device.type == "cuda"
               else [device] * n)
    print(f"mesh: {n} x-slab shard(s) over {device.type} devices")
    return SlabMesh.of(devices)


def _device(args) -> torch.device:
    """The device of --device: the card, or the CPU only when asked for and
    only under --mode bucketed."""
    if args.device == "cpu":
        if args.mode != "bucketed":
            raise SystemExit(f"--device cpu runs only --mode bucketed; mode "
                             f"{args.mode!r} runs the CUDA kernels")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible: --device cpu --mode bucketed runs "
                         "the plain engine on the CPU")
    return torch.device("cuda")


def _print_counters(state) -> None:
    lost, deferred, cfl, ceil = (int(v) for v in (
        state.lost, state.deferred, state.cfl_clamped, state.ceiling))
    print(f"lost: {lost} deferred: {deferred} cfl-clamped: {cfl}"
          + (f" window-ceiling: {ceil}" if ceil else ""))


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernels in this process."""
    from .ops.cuda import g2p_migrate, migrate_planes, p2g_shard, p2g_update, planes, substep2d
    from .render import blur_kernel, extract_kernel

    return {"p2g_update": p2g_update.launches, "g2p_migrate": g2p_migrate.launches,
            "g2p_migrate_emit": g2p_migrate.emit_launches,
            "p2g1_shard": p2g_shard.p2g1_launches, "p2g2u_shard": p2g_shard.p2g2u_launches,
            "g2p_migrate_shard": g2p_migrate.shard_launches,
            "sim2d": substep2d.sim2d_launches, "migrate2d": substep2d.migrate2d_launches,
            "extract_cells": extract_kernel.launches, "blur_depth": blur_kernel.launches,
            "p2g1_planes": planes.p2g1_launches, "p2g2_planes": planes.p2g2_launches,
            "g2p_planes": planes.g2p_launches, "migrate_planes": migrate_planes.launches}


def cmd_run(args) -> None:
    from .models.scenes import get_scene
    from .utils.timing import FrameStats, fence

    device = _device(args)
    scene = get_scene(args.scene, device=device)
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    mesh = _mesh(args, scene, device)
    step, state, win = build(scene, args.mode, args.window, substeps, mesh)
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
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))


def live_particles(state):
    """The live slots of a bucket state as a particle array: pos [3, K*C]
    with dead slots pushed to -1e6 (off the frame), and |vel| in float32."""
    from .render.camera import norm3

    pos = state.pos.reshape(3, -1)
    vel = state.vel.reshape(3, -1).float()
    live = state.mass.reshape(-1) > 0
    return torch.where(live, pos, -1e6), norm3(vel.T)


def cmd_render(args) -> None:
    """The frame loop of mpm_tpu/__main__.py cmd_render: with --window auto
    the air-window engine steps and render_frame_buckets draws (kernel X);
    with --window off, quality cell, a kernel mode and a drawing render
    mode, make_full_frame_step runs the substeps with kernel F's splat
    emission and draws from its splats; with --shards,
    make_sharded_frame_step composites the slabs' splats (--window off,
    quality cell and a drawing render mode only, as
    mpm_tpu/__main__.py:570-636); with --sphere-render-ratio below 1 the
    live slots feed render_frame as a particle array. A 2D scene takes
    _render_2d_loop. Frames leave the device as u8, and PNG writes overlap
    the next frames on worker threads."""
    from .models.scenes import get_scene
    from .render import (Camera, RenderConfig, SSFRParams, background_for_view,
                         default_view, domain_crop, frame_to_u8, load_cubemap,
                         make_full_frame_step, render_frame, render_frame_buckets)

    if args.render_mode == "legacy_quad":
        raise SystemExit("--render-mode legacy_quad is still to port (ROADMAP.md, queue 1, "
                         "item 'the dormant reference paths')")
    device = _device(args)
    scene = get_scene(args.scene, device=device)
    mesh = _mesh(args, scene, device)
    particle_path = args.sphere_render_ratio < 1.0
    if mesh is not None and args.window == "auto":
        raise SystemExit("--shards render supports --window off only (the windowed+sharded "
                         "engine is available via `run`)")
    if mesh is not None and particle_path:
        raise SystemExit("--shards render requires the bucket render path "
                         "(--sphere-render-ratio 1.0)")
    if mesh is not None and (args.render_quality != "cell" or args.render_mode == "none"):
        raise SystemExit("--shards render uses the distributed cell-splat composite: "
                         "requires --render-quality cell and a drawing --render-mode")
    if scene.config.dim == 2:
        return _render_2d_loop(args, scene, device)
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    cam = Camera(width=args.width, height=args.height)
    rc = RenderConfig(camera=cam, mode=args.render_mode,
                      ssfr=SSFRParams(particle_sphere_radius=args.sphere_radius,
                                      thickness_pass=args.thickness_pass,
                                      thickness_scale=args.thickness_scale),
                      sphere_render_ratio=args.sphere_render_ratio,
                      quality=args.render_quality, max_radius_px=args.max_radius_px)
    cubemap = load_cubemap(args.cubemap, device) if args.cubemap else None
    view = default_view(scene.config.grid_res)
    if args.crop == "auto":
        rc = domain_crop(rc, scene.config, view)
        if rc.crop:
            y0, x0, ch, cw = rc.crop
            print(f"fluid crop: {cw}x{ch}+{x0}+{y0} "
                  f"({cw * ch / (cam.width * cam.height):.0%} of frame)")
    step, state, win = build(scene, args.mode, args.window, substeps, mesh)
    print(f"scene={scene.name} N={n} grid={scene.config.grid_res} mode={args.mode} "
          f"window={args.window} {cam.width}x{cam.height} render-mode={rc.mode} "
          f"quality={rc.quality} thickness-pass={rc.ssfr.thickness_pass} "
          f"sphere-render-ratio={rc.sphere_render_ratio} cubemap={args.cubemap} "
          f"device={device}")
    bg = background_for_view(rc, view, device)
    full_frame = None
    if mesh is not None:
        from .parallel.render import make_sharded_frame_step

        full_frame = make_sharded_frame_step(scene.config, mesh, rc, substeps, mode=args.mode,
                                             cubemap_faces=cubemap)
    elif (args.mode != "bucketed" and win is None and rc.quality == "cell"
          and not particle_path and rc.mode != "none"):
        full_frame = make_full_frame_step(scene.config, rc, substeps, cubemap_faces=cubemap)
    grid_res = (win.config if win is not None else scene.config).grid_res

    def frame(state):
        if full_frame is not None:
            return full_frame(state, scene.fluid, (), view, bg)
        state = step(state, scene.fluid, ())
        if particle_path:
            pos, vmag = live_particles(state)
            img = render_frame(pos, vmag, view, rc, cubemap_faces=cubemap, bg=bg)
        else:
            img = render_frame_buckets(state, view, rc, bg=bg, grid_res=grid_res,
                                       cubemap_faces=cubemap)
        return state, frame_to_u8(img)

    state = _write_frames(args, frame, state, n, substeps, device)
    _print_counters(state)
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))


def _write_frames(args, frame, state, n: int, substeps: int, device) -> object:
    """The frame loop of `render`: `frame(state) -> (state, u8 frame)` on
    the device, the frame to the host, its PNG written on a worker thread
    while the next frames run. Prints the timing line; returns the state."""
    from .render import write_png
    from .utils.timing import FrameStats

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
    return state


def _render_2d_loop(args, scene, device) -> None:
    """The 2D frame loop (mpm_tpu/__main__.py's _render_2d_loop): step, draw
    the live slots with render_2d at 8 pixels a cell on the device, u8 to
    the host, PNG."""
    from .render import bucket_frame_2d, frame_to_u8

    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    step, state, _ = build(scene, args.mode, "off", substeps)
    res2 = scene.config.grid_res
    print(f"scene={scene.name} N={n} grid={res2} mode={args.mode} 2D frames "
          f"{res2[0] * 8}x{res2[1] * 8} device={device}")

    def frame(state):
        state = step(state, scene.fluid, ())
        return state, frame_to_u8(bucket_frame_2d(state, res2))

    state = _write_frames(args, frame, state, n, substeps, device)
    _print_counters(state)
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
