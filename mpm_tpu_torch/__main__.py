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
    python -m mpm_tpu_torch run dam_break_2d --mode reference
    python -m mpm_tpu_torch run fluid_3d --mode binned --device cpu
    python -m mpm_tpu_torch render fluid_3d --render-mode legacy_quad
    python -m mpm_tpu_torch render fluid_3d --width 1920 --height 1080 --trace frame.json
    python -m mpm_tpu_torch info

`run` steps a scene headless and prints per-run stats and the bucket
counters; `render` also draws every frame (3D scenes with the SSFR
renderer, 2D scenes with render/render2d.py) and writes it as a PNG. Both
run on the card (`--device cuda`, the default) and stop when none is
visible. Modes "auto" and "cuda" run the CUDA kernels (under
MPM_PALLAS_OLD=1 the per-pass kernels A, B, D and E, as the JAX package's
knob does); mode "bucketed" runs the plain PyTorch bucket engine; modes
"reference" (the dense-scatter oracle) and "binned" (the sorted engine)
step a linear particle state in plain PyTorch and draw it as a particle
array. `--device cpu` takes the plain modes: bucketed, reference and
binned. `--shards N` runs the x-slab decomposition (parallel/domain.py)
over the first N visible cards, or N CPU slabs under `--device cpu`.
`--trace PATH` writes a chrome trace of the frames after the first: the
program's `mpm.*` spans (utils/timing.span) over the card's kernels and
copies, on one clock.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .core.state import SimState


def _common(q: argparse.ArgumentParser) -> None:
    """The flags of both `run` and `render` (mpm_tpu/__main__.py:19-103)."""
    q.add_argument("scene", nargs="?", default="fluid_3d")
    q.add_argument("--frames", type=int, default=30)
    q.add_argument("--substeps", type=int, default=None,
                   help="substeps per frame (default: the scene's)")
    q.add_argument("--mode", default="auto",
                   choices=["auto", "bucketed", "cuda", "pallas", "reference", "binned"],
                   help="auto/cuda (pallas, the JAX package's name) = the CUDA kernels; "
                   "bucketed = the plain PyTorch bucket engine; reference = the "
                   "dense-scatter oracle; binned = the sorted engine (both on a "
                   "linear particle state)")
    q.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the card (stops when none is visible); cpu = "
                   "the plain engines on the CPU: --mode bucketed, reference or binned")
    q.add_argument("--window", default="off", choices=["off", "auto"],
                   help="auto = air-window engine (ops/window.py): arrays "
                   "track the occupied y-range; identical physics (3D only)")
    q.add_argument("--shards", type=int, default=0,
                   help="N > 0: x-slab decomposition over the first N visible "
                   "cards (N CPU slabs with --device cpu); 3D scenes")
    q.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="write the state every N frames (utils/checkpoint.py; "
                   "npz files the JAX package reads)")
    q.add_argument("--checkpoint-dir", default=os.path.join(tempfile.gettempdir(), "mpm_ckpt"),
                   help="directory of the checkpoints (default: mpm_ckpt in the "
                   "temporary directory)")
    q.add_argument("--resume", default=None, metavar="NPZ",
                   help="checkpoint to resume from (this package's or the JAX package's)")
    q.add_argument("--guard", action="store_true",
                   help="`run` only: async finiteness checks with verified-snapshot "
                   "rollback and dt backoff (utils/guard.GuardedStep)")
    q.add_argument("--guard-snapshot-every", type=int, default=32, metavar="N",
                   help="frames between rollback snapshots")
    q.add_argument("--guard-check-every", type=int, default=8, metavar="N",
                   help="frames between async finiteness checks")
    q.add_argument("--interact", action="append", default=[],
                   metavar="sphere=x,y[,z],r[,strength]",
                   help="radial force sphere (repeatable), the reference's sphere "
                   "collider (g2p.glsl:122-129)")
    q.add_argument("--fluid", action="append", default=[], metavar="KEY=VALUE",
                   help="override a fluid parameter (dt, gravity, rest_density, "
                   "dynamic_viscosity, eos_stiffness, eos_power, pressure_floor; "
                   "comma-separated vectors); repeatable. A scene with a static EOS "
                   "exponent keeps it")
    q.add_argument("--flip-gravity-at", type=int, default=0, metavar="FRAME",
                   help="invert gravity from this frame on")
    q.add_argument("--metrics", default=None, metavar="PATH",
                   help="append JSONL metrics (utils/metrics.py) here")
    q.add_argument("--trace", default=None, metavar="PATH",
                   help="profile the frames after the first (host and CUDA activity) and "
                        "write the chrome trace, with the program's mpm.* spans, here")
    q.add_argument("--orbit-sphere", action="store_true",
                   help="a repulsion sphere orbiting the domain centre, moved every frame")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mpm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="step a scene headless")
    render = sub.add_parser("render", help="step a scene and write PNG frames")
    _common(run)
    _common(render)
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
                        "domain's projected rectangle only (the same frame); a moving "
                        "camera takes none")
    render.add_argument("--render-mode", default="default",
                        choices=["default", "velocity_spheres", "lit_spheres", "depth_debug",
                                 "none", "legacy_quad"],
                        help="legacy_quad = the reference's dormant packed-depth "
                        "screen-quad chain (render/legacy.py; bucket modes, ratio 1)")
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
    render.add_argument("--orbit-camera", action="store_true",
                        help="the camera orbits the domain centre once over the run")
    render.add_argument("--fly", action="store_true",
                        help="interactive fly camera (render/flycam.py): w/a/s/d move, "
                        "q/e down/up, arrows or i/j/k/l look, +/- speed, SPACE pushes "
                        "the fluid with the sphere at the crosshair, Esc quits; reads "
                        "raw stdin, needs a terminal")
    render.add_argument("--fly-script", default=None, metavar="SPEC",
                        help="deterministic fly-camera key schedule, e.g. 'w:30,wl:10' "
                        "('.' = coast, 'p' = push); frames at a fixed 60 Hz delta")
    render.add_argument("--fly-speed", type=float, default=40.0,
                        help="fly speed, world units/s")
    render.add_argument("--fly-look-rate", type=float, default=2.5,
                        help="look rate, degrees per frame a look key is held")
    render.add_argument("--fly-plane-y", type=float, default=None,
                        help="the fly pointer's sphere sits where the crosshair ray "
                        "meets the plane y = PLANE_Y (default: domain height / 5)")
    render.add_argument("--fly-sphere-radius", type=float, default=None,
                        help="the fly pointer's sphere radius (default max(4, nx / 8))")
    render.add_argument("--fly-sphere-strength", type=float, default=1.0,
                        help="the fly pointer's radial push strength")
    render.add_argument("--hud", action="store_true",
                        help="burn the FPS / frame-time overlay into the frames "
                        "(render/hud.py)")
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


LINEAR_MODES = ("reference", "binned")  # modes that step a linear SimState


def build(scene, mode: str, window: str, substeps: int | None, mesh=None):
    """(step, state, win) for a scene whose state is on its device: the
    air-window engine when window == "auto", the scene is 3D and the mode
    steps buckets, else the frame step (on the scene's linear state in
    modes reference and binned); over the slab mesh `mesh` when one is
    given."""
    from .ops import bucketed
    from .ops.step import make_step
    from .ops.window import YWindow

    n = substeps or scene.config.substeps
    if mode in LINEAR_MODES:
        return make_step(scene.config, mode=mode, substeps=n), scene.state, None
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
    if scene.config.dim != 3 or args.mode in LINEAR_MODES:
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
    only in the plain modes (bucketed, reference, binned)."""
    if args.device == "cpu":
        if args.mode not in ("bucketed", *LINEAR_MODES):
            raise SystemExit(f"--device cpu runs only --mode bucketed, reference or "
                             f"binned; mode {args.mode!r} runs the CUDA kernels")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible: --device cpu --mode bucketed runs "
                         "the plain engine on the CPU")
    return torch.device("cuda")


def _print_counters(state) -> None:
    """The bucket counters; a linear state (modes reference and binned) has
    none, and prints its particle count and whether it is finite."""
    from .utils.guard import state_is_finite

    if isinstance(state, SimState):
        print(f"particles: {state.num_particles} finite: {state_is_finite(state)}")
        return
    lost, deferred, cfl, ceil = (int(v) for v in (
        state.lost, state.deferred, state.cfl_clamped, state.ceiling))
    print(f"lost: {lost} deferred: {deferred} cfl-clamped: {cfl}"
          + (f" window-ceiling: {ceil}" if ceil else ""))


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernels in this process, and
    `halo_copy`, the slab exchange's segments run as copy_ where a pair of
    cards has no peer access."""
    from .ops.cuda import (g2p_migrate, halo_fill, migrate_planes, p2g_shard, p2g_update,
                           planes, substep2d)
    from .render import blur_kernel, extract_kernel, shade_kernel, splat_kernel

    return {"p2g_update": p2g_update.launches, "g2p_migrate": g2p_migrate.launches,
            "g2p_migrate_emit": g2p_migrate.emit_launches,
            "p2g1_shard": p2g_shard.p2g1_launches, "p2g2u_shard": p2g_shard.p2g2u_launches,
            "g2p_migrate_shard": g2p_migrate.shard_launches,
            "halo_fill": halo_fill.fill_launches, "halo_full": halo_fill.full_launches,
            "halo_copy": halo_fill.copies,
            "sim2d": substep2d.sim2d_launches, "migrate2d": substep2d.migrate2d_launches,
            "extract_cells": extract_kernel.launches, "blur_depth": blur_kernel.launches,
            "ssfr_shade": shade_kernel.launches,
            "splat_zbuffer": splat_kernel.zbuffer_launches,
            "splat_dilate": splat_kernel.dilate_launches,
            "p2g1_planes": planes.p2g1_launches, "p2g2_planes": planes.p2g2_launches,
            "g2p_planes": planes.g2p_launches, "migrate_planes": migrate_planes.launches}


def reset_kernel_launches() -> None:
    """Sets every count kernel_launches reads to 0."""
    from .ops.cuda import (g2p_migrate, halo_fill, migrate_planes, p2g_shard, p2g_update,
                           planes, substep2d)
    from .render import blur_kernel, extract_kernel, shade_kernel, splat_kernel

    p2g_update.launches = g2p_migrate.launches = g2p_migrate.emit_launches = 0
    p2g_shard.p2g1_launches = p2g_shard.p2g2u_launches = g2p_migrate.shard_launches = 0
    halo_fill.fill_launches = halo_fill.full_launches = halo_fill.copies = 0
    substep2d.sim2d_launches = substep2d.migrate2d_launches = 0
    extract_kernel.launches = blur_kernel.launches = shade_kernel.launches = 0
    splat_kernel.zbuffer_launches = splat_kernel.dilate_launches = 0
    planes.p2g1_launches = planes.p2g2_launches = planes.g2p_launches = 0
    migrate_planes.launches = 0


def _apply_fluid_overrides(args, fluid):
    """--fluid KEY=VALUE and --flip-gravity-at (mpm_tpu/__main__.py:106-126):
    (fluid0, fluid_fn(frame) -> FluidParams). Values stay float32 CPU
    tensors of the field's shape; the kernels read them per call, so a
    change rebuilds nothing."""
    names = {f.name for f in dataclasses.fields(fluid)}
    for spec in args.fluid:
        key, _, val = spec.partition("=")
        if key not in names:
            raise SystemExit(f"unknown fluid parameter {key!r}")
        cur = getattr(fluid, key)
        arr = np.asarray([float(v) for v in val.split(",")], np.float32)
        if arr.size != cur.numel():
            raise SystemExit(f"--fluid {spec!r}: {key} takes {cur.numel()} value(s)")
        fluid = dataclasses.replace(fluid, **{key: torch.from_numpy(arr.reshape(cur.shape))})

    flip = args.flip_gravity_at
    flipped = dataclasses.replace(fluid, gravity=-fluid.gravity)

    def fluid_fn(frame):
        return flipped if flip and frame >= flip else fluid

    return fluid, fluid_fn


def _parse_interactions(args, config):
    """--interact sphere=... and --orbit-sphere (mpm_tpu/__main__.py:129-167):
    (interactions0, inter_fn(frame) -> tuple). A 2D scene takes spheres
    too, and the kernels take any number of them."""
    from .ops.interact import Interaction

    static = []
    for spec in args.interact:
        kind, _, rest = spec.partition("=")
        vals = [float(v) for v in rest.split(",") if v]
        if kind != "sphere" or len(vals) < config.dim + 1:
            raise SystemExit(f"bad --interact {spec!r}: expected sphere=x,y,z,r[,strength]")
        center, radius = vals[: config.dim], vals[config.dim]
        strength = vals[config.dim + 1] if len(vals) > config.dim + 1 else 1.0
        static.append(Interaction.sphere(center, radius=radius, strength=strength))

    if not args.orbit_sphere:
        inter = tuple(static)
        return inter, lambda frame: inter

    res = np.asarray(config.grid_res, np.float32)
    cx = res / 2.0
    orbit_r = float(res[0]) / 4.0
    radius = max(4.0, float(res[0]) / 8.0)

    def update(frame):
        ang = 2.0 * np.pi * frame / 120.0
        center = cx.copy()
        center[0] += orbit_r * np.cos(ang)
        center[-1] += orbit_r * np.sin(ang)
        if config.dim == 3:
            center[1] = res[1] / 5.0  # sweep through the pool depth
        orb = Interaction.sphere(center[: config.dim], radius=radius, strength=1.0)
        return tuple(static) + (orb,)

    return update(0), update


def _resume(args, scene, state, win, mesh, device):
    """--resume (mpm_tpu/__main__.py:271-314): (scene with the checkpoint's
    fluid, state at this run's shapes). A windowed checkpoint stores its
    window's arrays with domain_res the true grid: such a state, and any
    state of a windowed run, is un-windowed to a SimState and re-bucketed
    at this run's window; a SimState becomes buckets, and buckets a
    SimState in modes reference and binned; a sharded run shards it."""
    from .ops import bucketed
    from .utils import checkpoint

    ck, fluid, ck_config, _ = checkpoint.load(args.resume, device)
    ck_windowed = bool(ck_config and ck_config.get("domain_res"))
    if ck_config is not None:
        ck_grid = tuple(ck_config.get("domain_res")
                        or ck_config.get("grid_res", scene.config.grid_res))
        if ck_grid != tuple(scene.config.grid_res):
            raise SystemExit(f"checkpoint domain {ck_grid} != scene grid "
                             f"{scene.config.grid_res}; pass the matching scene")
    if (win is not None or ck_windowed) and isinstance(ck, bucketed.BucketState):
        ck = bucketed.to_simstate(ck)
    if win is not None:
        ck = win.init(ck)
    elif args.mode in LINEAR_MODES:
        if isinstance(ck, bucketed.BucketState):
            ck = bucketed.to_simstate(ck)
            print("converted bucket checkpoint state to linear")
    elif not isinstance(ck, bucketed.BucketState):
        ck = bucketed.from_simstate(ck, scene.config)
        print("converted linear checkpoint state to buckets")
    if mesh is not None and win is None:
        from .parallel.domain import shard_bucket_state

        ck = shard_bucket_state(ck, scene.config, mesh)
    print(f"resumed from {args.resume}")
    return scene._replace(fluid=fluid), ck


def _setup(args):
    """(device, scene, mesh, step, state, win) of `run` and `render`, the
    state resumed from --resume when given."""
    from .models.scenes import get_scene

    device = _device(args)
    scene = get_scene(args.scene, device=device)
    mesh = _mesh(args, scene, device)
    substeps = args.substeps or scene.config.substeps
    window = args.window if scene.config.dim == 3 else "off"
    step, state, win = build(scene, args.mode, window, substeps, mesh)
    if args.resume:
        scene, state = _resume(args, scene, state, win, mesh, device)
    return device, scene, mesh, step, state, win


def _checkpoint(args, frame: int, state, scene, win) -> None:
    """After frame `frame` (0-based), every --checkpoint-every frames: the
    state with the scene's fluid and config (a windowed run's window config,
    whose domain_res is the true grid)."""
    if not args.checkpoint_every or (frame + 1) % args.checkpoint_every:
        return
    from .utils import checkpoint

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    path = os.path.join(args.checkpoint_dir, f"frame_{frame + 1:05d}.npz")
    checkpoint.save(path, state, scene.fluid, win.config if win is not None else scene.config)
    print(f"checkpointed {path}")


def _log_counters(metrics, state) -> None:
    if isinstance(state, SimState):  # the bucket counters only (as the JAX CLI)
        return
    metrics.log("counters", lost=int(state.lost), deferred=int(state.deferred),
                cfl_clamped=int(state.cfl_clamped), ceiling=int(state.ceiling))


def cmd_run(args) -> None:
    from .utils.metrics import MetricsLogger
    from .utils.timing import FrameStats, end_trace, fence, start_trace

    device, scene, mesh, step, state, win = _setup(args)
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    inter0, inter_fn = _parse_interactions(args, scene.config)
    fluid0, fluid_fn = _apply_fluid_overrides(args, scene.fluid)
    scene = scene._replace(fluid=fluid0)
    print(f"scene={scene.name} N={n} grid={scene.config.grid_res} "
          f"mode={args.mode} device={device}"
          + (f" interactions={len(inter0)}" if inter0 else ""))
    if win is not None:
        print(f"air-window engine: wy={win.wy} of ny={scene.config.grid_res[1]}")

    metrics = MetricsLogger(path=args.metrics)
    if args.guard:
        from .utils.guard import GuardedStep

        step = GuardedStep(step, snapshot_every=args.guard_snapshot_every,
                           check_every=args.guard_check_every)
    t0 = time.perf_counter()
    state = step(state, scene.fluid, inter0)
    fence(state)
    compile_s = time.perf_counter() - t0
    print(f"first frame: {compile_s:.1f}s (builds the CUDA kernels on first use)")
    metrics.log("compile", seconds=round(compile_s, 3), scene=scene.name, mode=args.mode, n=n)

    stats = FrameStats()
    stats.tick()
    prof = start_trace(args.trace, device)
    for i in range(args.frames):
        state = step(state, fluid_fn(i), inter_fn(i))
        fence(state)
        stats.tick()
        if args.metrics:
            s_ = stats.stats
            metrics.log("frame", i=i, last_ms=round(s_["last_ms"], 3),
                        avg_ms=round(s_["avg_ms"], 3))
        _checkpoint(args, i, state, scene, win)
    end_trace(prof, args.trace)
    if args.guard:
        ok = step.flush()
        if step.failures or not ok:
            print(f"guard: {step.failures} rollback(s), {step.frames_lost} frame(s) lost, "
                  f"dt scale {step.current_dt_scale:g}")
            if not ok:
                state = step.last_good()
        metrics.log("guard", failures=step.failures, frames_lost=step.frames_lost,
                    dt_scale=step.current_dt_scale)
    s = stats.stats
    pps = n * substeps * s["fps"]
    print(f"frames={args.frames} avg={s['avg_ms']:.2f}ms min={s['min_ms']:.2f} "
          f"max={s['max_ms']:.2f} fps={s['fps']:.1f} -> {pps / 1e6:.1f}M "
          f"particle-steps/s on {device}")
    _print_counters(state)
    _log_counters(metrics, state)
    metrics.log("summary", frames=args.frames, fps=round(s["fps"], 2),
                particle_steps_per_sec=round(pps, 1))
    metrics.close()
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))


def live_particles(state):
    """The live slots of a bucket state as a particle array: pos [3, K*C]
    with dead slots pushed to -1e6 (off the frame), and |vel| in float32; a
    linear SimState's particles as they are."""
    from .render.camera import norm3

    if isinstance(state, SimState):
        return state.pos, norm3(state.vel.float().T)
    pos = state.pos.reshape(3, -1)
    vel = state.vel.reshape(3, -1).float()
    live = state.mass.reshape(-1) > 0
    return torch.where(live, pos, -1e6), norm3(vel.T)


def _camera(args, scene):
    """The render loop's camera (mpm_tpu/__main__.py:494-561): (view_fn(frame)
    -> [4, 4] float32 CPU view, moves, key source or None, SpherePointer or
    None). --fly / --fly-script fly it (the pointer steers a sphere in 3D),
    --orbit-camera circles the domain once over the run, else the scene's
    default view, one tensor for every frame. A moving camera's view is
    made on the host each frame, so the render scalars never come back
    from the card."""
    from .render import default_view, look_at

    c = [r / 2.0 for r in scene.config.grid_res]
    if args.fly_script or args.fly:
        from .render.flycam import FlyCamera, ScriptKeys, SpherePointer, TerminalKeys

        src = ScriptKeys(args.fly_script) if args.fly_script else TerminalKeys()
        cam = FlyCamera((c[0] + 55.0, c[1] + 28.0, c[2] + 55.0), (c[0], c[1] - 8.0, c[2]),
                        speed=args.fly_speed, look_rate=args.fly_look_rate)
        pointer = SpherePointer(scene.config, plane_y=args.fly_plane_y,
                                radius=args.fly_sphere_radius,
                                strength=args.fly_sphere_strength)
        prev = [time.perf_counter()]

        def view_fn(frame):
            now = time.perf_counter()
            # scripted flights step a fixed 60 Hz delta (replayable),
            # interactive ones the frame's own, as the reference does
            dt = 1.0 / 60.0 if args.fly_script else min(now - prev[0], 0.25)
            prev[0] = now
            keys = src.poll()
            cam.apply_keys(keys, dt)
            pointer.update(cam, keys)
            return torch.from_numpy(cam.view())

        return view_fn, True, src, pointer
    if args.orbit_camera:
        def view_fn(frame):
            ang = 2.0 * np.pi * frame / max(args.frames, 1)
            eye = (c[0] + 75.0 * np.cos(ang), c[1] + 28.0, c[2] + 75.0 * np.sin(ang))
            return torch.from_numpy(look_at(eye, (c[0], c[1] - 8.0, c[2])))

        return view_fn, True, None, None
    view = default_view(scene.config.grid_res)
    return (lambda frame: view), False, None, None


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
    _render_2d_loop. Every frame takes its fluid, interactions and view
    from the run-time flags; a moving camera (--orbit-camera, --fly,
    --fly-script) traces the background each frame and takes no crop."""
    from .render import (Camera, RenderConfig, SSFRParams, background_for_view, domain_crop,
                         frame_to_u8, load_cubemap, make_full_frame_step, render_frame,
                         render_frame_buckets)

    particle_path = args.sphere_render_ratio < 1.0 or args.mode in LINEAR_MODES
    if args.shards and args.window == "auto":
        raise SystemExit("--shards render supports --window off only (the windowed+sharded "
                         "engine is available via `run`)")
    if args.shards and particle_path:
        raise SystemExit("--shards render requires the bucket render path "
                         "(--sphere-render-ratio 1.0)")
    if args.shards and (args.render_quality != "cell"
                        or args.render_mode in ("none", "legacy_quad")):
        raise SystemExit("--shards render uses the distributed cell-splat composite: "
                         "requires --render-quality cell and a drawing --render-mode")
    device, scene, mesh, step, state, win = _setup(args)
    fluid0, fluid_fn = _apply_fluid_overrides(args, scene.fluid)
    scene = scene._replace(fluid=fluid0)
    if scene.config.dim == 2:
        return _render_2d_loop(args, scene, step, state, device, fluid_fn)
    if args.render_mode == "legacy_quad" and particle_path:
        raise SystemExit("--render-mode legacy_quad reads the bucket-state texture contract: "
                         "requires a 3D bucketed/cuda scene and --sphere-render-ratio 1.0")
    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    view_fn, moves, keys, pointer = _camera(args, scene)
    inter_fn = _parse_interactions(args, scene.config)[1]
    if pointer is not None:
        # the pointer's sphere is in every frame's tuple; `active` gates it
        base_inter_fn = inter_fn

        def inter_fn(frame):
            return base_inter_fn(frame) + (pointer.interaction(),)

    cam = Camera(width=args.width, height=args.height)
    rc = RenderConfig(camera=cam, mode=args.render_mode,
                      ssfr=SSFRParams(particle_sphere_radius=args.sphere_radius,
                                      thickness_pass=args.thickness_pass,
                                      thickness_scale=args.thickness_scale),
                      sphere_render_ratio=args.sphere_render_ratio,
                      quality=args.render_quality, max_radius_px=args.max_radius_px)
    cubemap = load_cubemap(args.cubemap, device) if args.cubemap else None
    if args.crop == "auto" and not moves:
        rc = domain_crop(rc, scene.config, view_fn(0))
        if rc.crop:
            y0, x0, ch, cw = rc.crop
            print(f"fluid crop: {cw}x{ch}+{x0}+{y0} "
                  f"({cw * ch / (cam.width * cam.height):.0%} of frame)")
    print(f"scene={scene.name} N={n} grid={scene.config.grid_res} mode={args.mode} "
          f"window={args.window} {cam.width}x{cam.height} render-mode={rc.mode} "
          f"quality={rc.quality} thickness-pass={rc.ssfr.thickness_pass} "
          f"sphere-render-ratio={rc.sphere_render_ratio} cubemap={args.cubemap} "
          f"camera={'moving' if moves else 'static'} device={device}"
          + (f" interactions={len(inter_fn(0))}" if inter_fn(0) else ""))
    # a static camera's background is traced once; a moving one's each frame
    bg = None if moves else background_for_view(rc, view_fn(0), device)
    full_frame = None
    if mesh is not None:
        from .parallel.render import make_sharded_frame_step

        full_frame = make_sharded_frame_step(scene.config, mesh, rc, substeps, mode=args.mode,
                                             cubemap_faces=cubemap)
    elif (args.mode != "bucketed" and win is None and rc.quality == "cell"
          and not particle_path and rc.mode not in ("none", "legacy_quad")):
        full_frame = make_full_frame_step(scene.config, rc, substeps, cubemap_faces=cubemap)

    def frame(state, i):
        view, fp, inter = view_fn(i), fluid_fn(i), inter_fn(i)
        if full_frame is not None:
            return full_frame(state, fp, inter, view, bg)
        state = step(state, fp, inter)
        if particle_path:
            pos, vmag = live_particles(state)
            img = render_frame(pos, vmag, view, rc, cubemap_faces=cubemap, bg=bg)
        else:
            grid_res = (win.config if win is not None else scene.config).grid_res
            img = render_frame_buckets(state, view, rc, bg=bg, grid_res=grid_res,
                                       cubemap_faces=cubemap, num_particles=n)
        return state, frame_to_u8(img)

    state = _write_frames(args, frame, state, scene, win, device, keys)
    _print_counters(state)
    if win is not None:
        print(f"window: wy={win.wy} resizes={win.resizes} "
              f"interference={win.interference}")
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))


def _to_host(img: torch.Tensor, copier):
    """Fence a frame and start its copy to the host: (host tensor, done,
    copied). On a card `done` marks the end of the frame's work on the
    current stream, which the loop waits for (the frame's device time);
    the copy into pinned memory runs behind it on the `copier` stream,
    overlapping the next frame's work, and `copied` marks its end, which
    the worker thread waits for. On the CPU the frame is its own host
    tensor and there are no events."""
    if img.device.type != "cuda":
        return img, None, None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(img.device))
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    copier.wait_event(done)
    with torch.cuda.stream(copier):
        host.copy_(img, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(copier)
    img.record_stream(copier)  # the allocator keeps img until the copy ends
    return host, done, copied


def _write_frames(args, frame, state, scene, win, device, keys=None):
    """The frame loop of `render` (mpm_tpu/__main__.py:684-794):
    `frame(state, i) -> (state, u8 frame)` on the device. The frame's copy
    to the host starts at once on a stream of its own; its host side (the
    wait for the copy, the HUD, the PNG) runs on a worker thread while the
    next frames run. Each frame after the first records its device time
    (dispatch to the fenced frame) and the loop's host time (handing the
    previous frame over),
    which the HUD's DEV | HOST line and the `frame` metrics read. With
    --trace the frames after the first run under the profiler. Stops
    early when the fly camera's keys quit. Prints the timing line and
    writes the metrics; returns the state."""
    from .render import write_png
    from .utils.metrics import MetricsLogger
    from .utils.timing import FrameStats, end_trace, start_trace

    n = scene.state.num_particles
    substeps = args.substeps or scene.config.substeps
    os.makedirs(args.out, exist_ok=True)
    metrics = MetricsLogger(path=args.metrics)
    stats = FrameStats()

    def host_side(host, event, hud_stats, idx):
        if event is not None:
            event.synchronize()
        img = host.numpy()
        if args.hud:
            from .render.hud import burn_in_hud

            img = burn_in_hud(img, hud_stats, extra=f"N={n}")
        write_png(os.path.join(args.out, f"frame_{idx:05d}.png"), img)

    copier = torch.cuda.Stream(device) if device.type == "cuda" else None
    t0 = time.perf_counter()
    frames = 0
    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = []

        def flush(host, event, idx):
            # the HUD reads a copy of the stats as they stand when the frame
            # is handed over: the loop goes on adding to its own
            pending.append(pool.submit(host_side, host, event, copy.deepcopy(stats), idx))
            if len(pending) > 4:
                pending.pop(0).result()

        prev = prof = None
        for i in range(args.frames):
            if keys is not None and keys.quit:
                print(f"fly camera: quit at frame {i}")
                break
            td0 = time.perf_counter()
            state, img = frame(state, i)
            host, done, copied = _to_host(img, copier)
            th0 = time.perf_counter()
            if prev is not None:
                flush(*prev)
            host_s = time.perf_counter() - th0
            if done is not None:
                done.synchronize()
            if i > 0:  # the first frame's device time is the kernels' build
                stats.split(time.perf_counter() - td0, host_s)
            prev = (host, copied, i)
            stats.tick()
            frames += 1
            if i == 0:
                first_s = time.perf_counter() - t0
                print(f"first frame: {first_s:.1f}s (builds the CUDA kernels on first use)")
                metrics.log("compile", seconds=round(first_s, 3), scene=scene.name,
                            mode=args.mode, n=n)
                prof = start_trace(args.trace, device)
            elif args.metrics:
                s_ = stats.stats
                metrics.log("frame", i=i, last_ms=round(s_["last_ms"], 3),
                            dev_ms=round(s_["dev_ms"], 3), host_ms=round(s_["host_ms"], 3))
            _checkpoint(args, i, state, scene, win)
        end_trace(prof, args.trace)
        if keys is not None:
            keys.close()  # restore the terminal before the summary
        if prev is not None:
            flush(*prev)
        for f in pending:
            f.result()
    s = stats.stats
    print(f"{frames} frames -> {args.out} (avg {s['avg_ms']:.2f} ms/frame after the "
          f"first, min {s['min_ms']:.2f} max {s['max_ms']:.2f}, incl. PNG writes; dev "
          f"{s['dev_ms']:.2f} ms | host {s['host_ms']:.2f} ms) -> "
          f"{n * substeps * s['fps'] / 1e6:.1f}M particle-steps/s with render on {device}")
    _log_counters(metrics, state)
    metrics.log("summary", frames=frames, avg_ms=round(s["avg_ms"], 2),
                dev_ms=round(s["dev_ms"], 2), host_ms=round(s["host_ms"], 2))
    metrics.close()
    return state


def _render_2d_loop(args, scene, step, state, device, fluid_fn) -> None:
    """The 2D frame loop (mpm_tpu/__main__.py's _render_2d_loop): step with
    the frame's fluid and interactions, draw the live slots with render_2d
    at 8 pixels a cell on the device, u8 to the host, HUD, PNG."""
    from .render import bucket_frame_2d, frame_to_u8

    inter0, inter_fn = _parse_interactions(args, scene.config)
    res2 = scene.config.grid_res
    print(f"scene={scene.name} N={scene.state.num_particles} grid={res2} mode={args.mode} "
          f"2D frames {res2[0] * 8}x{res2[1] * 8} device={device}"
          + (f" interactions={len(inter0)}" if inter0 else ""))

    def frame(state, i):
        state = step(state, fluid_fn(i), inter_fn(i))
        return state, frame_to_u8(bucket_frame_2d(state, res2))

    state = _write_frames(args, frame, state, scene, None, device)
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
    if args.cmd != "info" and args.mode == "pallas":  # the JAX package's name of the kernels
        args.mode = "cuda"
    {"run": cmd_run, "render": cmd_render, "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])
