#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from mpm_tpu_torch/csrc (P, F with its splat emission,
X and BL, one nvcc each, in parallel), holds each against its plain PyTorch
version at full width, replays the 3D golden trajectory through the kernels,
drives the main paths (the 1M benchmark pool under the air-window engine;
its render loop at 640x360 and at 1080p on the frozen window, and the
windowed render path; the 1M dam-break), runs the CLI, and times each kernel
beside its plain version. Every main path runs with the launch counts set to
0 just before it and read just after. Any failure raises, so the exit code
is not 0. The line before the last is a JSON summary of the kernels; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mpm_tpu_torch.__main__ import kernel_launches, nvidia_smi_power
from mpm_tpu_torch.models.scenes import benchmark_dam_break, benchmark_scene, fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.cuda import build
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.render import (Camera, background_for_view, default_view, frame_to_u8,
                                  make_full_frame_step, render_frame_buckets, write_png)
from mpm_tpu_torch.render import blur_kernel as kb
from mpm_tpu_torch.render import extract_kernel as kx
from mpm_tpu_torch.render.image import read_png_rgb
from mpm_tpu_torch.render.splat import splat_cells, surface_band_uncovered
from mpm_tpu_torch.utils.render_bench import (N_POOL, frame_windows, pool_window, recipe_360,
                                              recipe_1080, settle)
from mpm_tpu_torch.utils.timing import cuda_time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_3D = os.path.join(ROOT, "tests", "golden", "fluid_3d_small_bucketed.npz")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_p(state, config, fluid, label: str) -> float:
    """Kernel P vs plain; gvel within 1e-5 of max |v|. Returns max abs error."""
    got = kp.p2g_update(state, config, fluid)
    want = kp.p2g_update_plain(state, config, fluid)
    torch.cuda.synchronize()
    scale = float(want.mom.abs().max())
    err = max(max_err(got.mom, want.mom), max_err(got.mass, want.mass))
    if not scale > 0 or err > 1e-5 * scale:
        raise AssertionError(f"kernel P vs plain ({label}): max err {err} > "
                             f"1e-5 * max|v| = {1e-5 * scale}")
    phase("P", f"{label}: gvel max|v|={scale:.4g} max abs err={err:.3g} "
          f"(bar 1e-5 * max|v|); bit-equal={bool(torch.equal(got.mom, want.mom))}")
    return err


def compare_states(got, want, config, label: str) -> float:
    """Kernel F's bars: ids slot for slot, pos atol 1e-6, vel/C atol 1e-5
    (f32) or rtol 0.01 atol 1e-4 (bf16), counters equal (the JAX package's
    bars, tests/test_fused.py). Returns the max abs error."""
    if not torch.equal(got.ids, want.ids):
        raise AssertionError(f"kernel F ({label}): ids differ in "
                             f"{int((got.ids != want.ids).sum())} slots")
    torch.testing.assert_close(got.pos, want.pos, rtol=0, atol=1e-6)
    bf16 = config.vc_dtype == torch.bfloat16
    for a, b in ((got.vel, want.vel), (got.C, want.C)):
        if bf16:
            torch.testing.assert_close(a.float(), b.float(), rtol=0.01, atol=1e-4)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    counters = ("lost", "cfl_clamped", "deferred", "ceiling")
    for name in counters:
        if int(getattr(got, name)) != int(getattr(want, name)):
            raise AssertionError(f"kernel F ({label}): {name} differs")
    err = max(max_err(got.pos, want.pos), max_err(got.vel, want.vel),
              max_err(got.C, want.C))
    phase("F", f"{label}: ids equal, max abs err over pos/vel/C={err:.3g}, "
          f"counters " + " ".join(f"{n}={int(getattr(got, n))}" for n in counters))
    return err


def check_f(state, grid, config, fluid, label: str) -> float:
    """Kernel F vs plain from the same grid velocity."""
    got = kf.g2p_migrate(state, grid, config, fluid)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    torch.cuda.synchronize()
    return compare_states(got, want, config, label)


def compare_splats(got, want, label: str) -> float:
    """Kernel X's bar: rows 2 (depth) and 4 (count) equal, rows 0, 1, 3
    within rtol 1e-6 atol 1e-5 (tests/test_render.py:370)."""
    for r in (2, 4):
        if not torch.equal(got[r], want[r]):
            raise AssertionError(f"{label}: splat row {r} differs in "
                                 f"{int((got[r] != want[r]).sum())} cells")
    for r in (0, 1, 3):
        torch.testing.assert_close(got[r], want[r], rtol=1e-6, atol=1e-5)
    live = want[2] < kx.CELL_BG
    return max_err(got[:, live], want[:, live]) if bool(live.any()) else 0.0


def check_x(state, view, cam, label: str) -> float:
    got = kx.extract_cell_splats(state, view, cam)
    want = kx.extract_cell_splats_plain(state, view, cam)
    torch.cuda.synchronize()
    err = compare_splats(got, want, f"kernel X ({label})")
    phase("X", f"{label}: {int((want[2] < kx.CELL_BG).sum())} of {want.shape[1]} cells "
          f"splat; rows 2, 4 equal; max abs err {err:.3g} (bar rtol 1e-6 atol 1e-5)")
    return err


def check_f_emit(state, grid, config, fluid, rs, label: str) -> float:
    """Kernel F with emission vs plain: the state at check_f's bars and the
    splats against the plain extraction of the plain state at X's bar."""
    got, splats = kf.g2p_migrate(state, grid, config, fluid, emit_splats=True,
                                 render_scals=rs)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    torch.cuda.synchronize()
    err = compare_states(got, want, config, f"{label}, emitting")
    serr = compare_splats(splats, kx.cell_splats_plain(want.pos, want.vel, want.mass, rs),
                          f"kernel F emission ({label})")
    phase("F-emit", f"{label}: splats rows 2, 4 equal; max abs err {serr:.3g}")
    return max(err, serr)


def check_bl(depth, cam, label: str) -> float:
    """Kernel BL vs plain at radius 100: atol 2e-4 rtol 1e-5
    (tests/test_render.py:240). Prints the largest filter size that ran."""
    kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
    got = kb.blur_depth_kernel(depth, cam, **kw)
    want = kb.blur_depth_plain(depth, cam, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
    pc = kb.proj_const_for(cam, 7.0)
    bx = kb.blur_pass_plain(depth, 1, 100, 100, pc, 10.0)
    live = [(d > 0) & (d <= kb.FAR_GUARD) for d in (depth, bx)]
    fmax = max(int(torch.where(lv, kb.filter_sizes(d, 100, 100, pc), 0.0).max())
               for lv, d in zip(live, (depth, bx)))
    err = max_err(got, want)
    phase("BL", f"{label} {tuple(depth.shape)}: max abs err {err:.3g} (bar atol 2e-4 "
          f"rtol 1e-5), bit-equal={bool(torch.equal(got, want))}, largest fsize {fmax}")
    return err, fmax


def reset_launches() -> None:
    kp.launches = kf.launches = kf.emit_launches = kx.launches = kb.launches = 0


def fluid_share(img, bg_u8, crop) -> float:
    """Share of the crop's pixels where the frame differs from the
    background by more than 2 LSB in some channel."""
    y0, x0, ch, cw = crop
    d = (img.int() - bg_u8.int()).abs().amax(dim=-1)[y0:y0 + ch, x0:x0 + cw]
    return float((d > 2).float().mean())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_power()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    phase("device", f"{name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    print(smi, flush=True)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    build.build_all(["p2g_update", "g2p_migrate", "extract_cells", "blur_depth"])
    phase("build", f"{time.perf_counter() - t0:.1f}s; nvcc per kernel: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in build.build_seconds.items()))

    # 3-4. kernels vs plain: fluid_3d at full width (f32, K=16) after three
    # plain substeps, and the benchmark pool's window (bf16, K=8)
    sc = fluid_3d(device=dev)
    cfg3 = sc.config
    s3 = bucketed.from_simstate(sc.state, cfg3)
    for _ in range(3):
        s3 = bucketed.substep(s3, cfg3, sc.fluid)
    pool = benchmark_scene(N_POOL, device=dev)
    win = pool_window(pool)
    sp = win.init(pool.state)
    cfgp = win.config
    for _ in range(2):
        sp = bucketed.substep(sp, cfgp, pool.fluid)
    err_p = max(check_p(s3, cfg3, sc.fluid, f"fluid_3d {cfg3.grid_res} K=16 f32"),
                check_p(sp, cfgp, pool.fluid, f"pool window {cfgp.grid_res} K=8 bf16"))
    err_f = max(
        check_f(s3, kp.p2g_update_plain(s3, cfg3, sc.fluid), cfg3, sc.fluid,
                f"fluid_3d {cfg3.grid_res} K=16 f32"),
        check_f(sp, kp.p2g_update_plain(sp, cfgp, pool.fluid), cfgp, pool.fluid,
                f"pool window {cfgp.grid_res} K=8 bf16"))
    # render kernels at the render path's cameras: kernel X and kernel F's
    # emission (f32 K=16 here; the settled pool window below)
    view3 = default_view(cfg3.grid_res)
    cam360 = Camera(width=640, height=360)
    err_x = check_x(s3, view3, cam360, f"fluid_3d {cfg3.grid_res} K=16 f32")
    rs3 = kx.render_scals_for(view3, cam360)
    err_fe = check_f_emit(s3, kp.p2g_update_plain(s3, cfg3, sc.fluid), cfg3, sc.fluid,
                          rs3, f"fluid_3d {cfg3.grid_res} K=16 f32")
    del s3, sp

    # 5. golden anchor: the 3D bucket-engine fixture through the kernels
    data = np.load(GOLDEN_3D)
    gs = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=dev)
    gcfg = gs.config.replace(bin_capacity=8)
    b = bucketed.from_simstate(gs.state, gcfg)
    step1 = make_step(gcfg, mode="cuda", substeps=1)
    for i in range(1, 31):
        b = step1(b, gs.fluid)
        if i in (10, 30):
            got = bucketed.to_simstate(b).pos.cpu().numpy()
            err = float(np.abs(got - data[f"pos_s{i}"]).max())
            if not err <= 5e-4 or int(b.lost) != 0:
                raise AssertionError(f"golden anchor substep {i}: err {err}")
            phase("golden", f"substep {i}: max |pos - fixture| = {err:.3g} (bar 5e-4)")

    # 6. main path: the 1M pool under the air-window engine
    state = win.init(pool.state)
    n = pool.state.num_particles
    reset_launches()
    state = settle(win, state, pool.fluid)
    torch.cuda.synchronize()
    if int(state.lost) != 0:
        raise AssertionError(f"pool lost {int(state.lost)} particles while settling")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):  # 100 substeps
            state = win.step(state, pool.fluid)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"p2g_update": kp.launches, "g2p_migrate": kf.launches}
    lost = int(state.lost)
    if lost != 0 or win.interference != 0:
        raise AssertionError(f"pool: lost={lost} interference={win.interference}")
    if not bool(torch.isfinite(state.pos).all()):
        raise AssertionError("pool: non-finite positions")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path did not launch every kernel: {launches}")
    pps = sorted(100 * n / t for t in times)
    phase("pool", f"{n} particles, grid {pool.config.grid_res}, window wy={win.wy}, "
          f"windows {[round(t, 4) for t in times]} s per 100 substeps -> "
          f"best {pps[-1] / 1e6:.1f}M median {pps[1] / 1e6:.1f}M particle-steps/s; "
          f"lost=0 interference=0 deferred={int(state.deferred)} "
          f"cfl_clamped={int(state.cfl_clamped)} launches={launches} [{smi}]")

    # 9 (at the pool's shapes). kernel time vs plain time, one call each,
    # in turns plain, kernel, kernel, plain
    cfgw = win.config
    grid = kp.p2g_update(state, cfgw, pool.fluid)
    runs = {"p2g_update": (lambda: kp.p2g_update(state, cfgw, pool.fluid),
                           lambda: kp.p2g_update_plain(state, cfgw, pool.fluid)),
            "g2p_migrate": (lambda: kf.g2p_migrate(state, grid, cfgw, pool.fluid),
                            lambda: kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid))}
    timing = {}

    def time_pair(kname, kern, plain, shape):
        p1 = cuda_time_ms(plain, iters=5)
        k1 = cuda_time_ms(kern, iters=50)
        k2 = cuda_time_ms(kern, iters=50)
        p2 = cuda_time_ms(plain, iters=5)
        timing[kname] = ((k1 + k2) / 2, (p1 + p2) / 2)
        phase("time", f"{kname} at {shape}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms [{smi}]")

    for kname, (kern, plain) in runs.items():
        time_pair(kname, kern, plain, f"window {cfgw.grid_res} K={cfgw.bin_capacity}")

    # kernels X and F-with-emission on the settled pool window (bf16, K=8)
    view = default_view(pool.config.grid_res)  # the scene's camera, not the window's
    rs = kx.render_scals_for(view, cam360)
    err_x = max(err_x, check_x(state, view, cam360, f"settled pool window {cfgw.grid_res} "
                                                    "K=8 bf16"))
    err_fe = max(err_fe, check_f_emit(state, grid, cfgw, pool.fluid, rs,
                                      f"settled pool window {cfgw.grid_res} K=8 bf16"))
    def emit_plain():
        out = kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid)
        return kx.cell_splats_plain(out.pos, out.vel, out.mass, rs)

    time_pair("g2p_migrate_emit",
              lambda: kf.g2p_migrate(state, grid, cfgw, pool.fluid, emit_splats=True,
                                     render_scals=rs),
              emit_plain, f"window {cfgw.grid_res} K=8")
    time_pair("extract_cells", lambda: kx.extract_cell_splats(state, view, cam360),
              lambda: kx.extract_cell_splats_plain(state, view, cam360),
              f"window {cfgw.grid_res} K=8")
    del grid, runs

    # 10. kernel BL on real splat buffers of the pool plus a near patch at
    # depth 1.5, full frames at 640x360 and 1920x1080
    err_bl, fsize_max = 0.0, 0
    bl_bufs = {}
    for cam in (cam360, Camera(width=1920, height=1080)):
        cells = kx.extract_cell_splats(state, view, cam)
        depth = splat_cells(cells, cam, 1.0, 6 if cam.width < 1000 else 8).depth
        bl_bufs[cam.width] = depth.clone()
        depth[cam.height // 3:cam.height // 3 + 24, cam.width // 3:cam.width // 3 + 40] = 1.5
        e, f = check_bl(depth.contiguous(), cam, f"pool splat buffer {cam.width}x{cam.height}"
                        " + near patch")
        err_bl, fsize_max = max(err_bl, e), max(fsize_max, f)
    if fsize_max < 100:
        raise AssertionError(f"kernel BL never ran fsize 100 (largest {fsize_max})")

    # 11. main path: the render loop at 640x360 on the frozen settled window
    # (bench.py's with-render line): 2 substeps a frame, the last with kernel
    # F's emission, cell quality, the domain crop, u8 frames to the host
    lost0 = int(state.lost)
    rc = recipe_360(pool.config, view)
    bg = background_for_view(rc, view, dev)
    subs = pool.config.substeps
    frame = make_full_frame_step(cfgw, rc, subs)
    state, _ = frame(state, pool.fluid, (), view, bg)  # warm
    bl_bufs["crop360"] = bl_bufs[cam360.width][rc.crop[0]:rc.crop[0] + rc.crop[2],
                                      rc.crop[1]:rc.crop[1] + rc.crop[3]].contiguous()
    reset_launches()
    state, img, rtimes = frame_windows(frame, state, pool.fluid, view, bg, 40, 3)
    launches360 = kernel_launches()
    ceiling = int(state.ceiling)
    if int(state.lost) != lost0 or ceiling != 0:
        raise AssertionError(f"640x360 render: lost {int(state.lost) - lost0}, "
                             f"ceiling {ceiling}")
    for k in ("p2g_update", "g2p_migrate", "g2p_migrate_emit", "blur_depth"):
        if launches360[k] <= 0:
            raise AssertionError(f"640x360 render did not launch {k}: {launches360}")
    fimg = render_frame_buckets(state, view, rc, bg=bg)
    if not bool(torch.isfinite(fimg).all()):
        raise AssertionError("640x360 render: non-finite frame")
    share = fluid_share(img, frame_to_u8(bg[0]), rc.crop)
    if share < 0.1:
        raise AssertionError(f"640x360 render: fluid on only {share:.3f} of the crop")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_frames_") as outdir:
        png = os.path.join(outdir, "pool_640x360.png")
        write_png(png, img.cpu().numpy())
        png_bytes = os.path.getsize(png)
        if not np.array_equal(read_png_rgb(png), img.cpu().numpy()):
            raise AssertionError("640x360 render: the PNG does not read back as the frame")
    rps = sorted(40 * subs * n / t for t in rtimes)
    phase("render360", f"crop {rc.crop}, windows {[round(t, 4) for t in rtimes]} s per "
          f"40 frames -> {min(rtimes) / 40 * 1e3:.3f} ms/frame best, "
          f"{sorted(rtimes)[1] / 40 * 1e3:.3f} median; best {rps[-1] / 1e6:.1f}M median "
          f"{rps[1] / 1e6:.1f}M particle-steps/s with render; lost 0 ceiling 0; fluid on "
          f"{share:.3f} of the crop (bar 0.1); launches {launches360}; PNG of {png_bytes} B "
          f"reads back equal "
          f"[{smi}]")

    # 12. main path: 1080p, particle quality with surface bands (R=8,
    # refraction downsample 4; bench.py:381-464), on the frozen window
    rc1080 = recipe_1080(pool.config, state, cfgw.grid_res, view)
    bands = rc1080.surface_bands
    bg1080 = background_for_view(rc1080, view, dev)
    frame1080 = make_full_frame_step(cfgw, rc1080, subs)
    state, _ = frame1080(state, pool.fluid, (), view, bg1080)  # warm
    bl_bufs["crop1080"] = bl_bufs[rc1080.camera.width][
        rc1080.crop[0]:rc1080.crop[0] + rc1080.crop[2],
        rc1080.crop[1]:rc1080.crop[1] + rc1080.crop[3]].contiguous()
    reset_launches()
    state, img1080, htimes = frame_windows(frame1080, state, pool.fluid, view, bg1080, 10, 2)
    launches1080 = kernel_launches()
    uncovered = surface_band_uncovered(state, cfgw.grid_res, bands)
    if int(state.lost) != lost0 or int(state.ceiling) != 0 or uncovered != 0:
        raise AssertionError(f"1080p render: lost {int(state.lost) - lost0}, ceiling "
                             f"{int(state.ceiling)}, band certificate {uncovered}")
    if min(launches1080[k] for k in ("g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"1080p render did not launch every kernel: {launches1080}")
    share1080 = fluid_share(img1080, frame_to_u8(bg1080[0]), rc1080.crop)
    if share1080 < 0.1:
        raise AssertionError(f"1080p render: fluid on only {share1080:.3f} of the crop")
    hps = sorted(10 * subs * n / t for t in htimes)
    phase("render1080", f"bands {bands}, crop {rc1080.crop}, windows "
          f"{[round(t, 4) for t in htimes]} s per 10 frames -> "
          f"{min(htimes) / 10 * 1e3:.3f} ms/frame best; best {hps[-1] / 1e6:.1f}M "
          f"particle-steps/s with render; lost 0 ceiling 0 band certificate 0; fluid on "
          f"{share1080:.3f} of the crop; launches {launches1080} [{smi}]")

    # kernel BL at the crops the two render loops blur: against its plain
    # version, then timed beside it
    for key, cam in (("crop360", rc.camera), ("crop1080", rc1080.camera)):
        d = bl_bufs[key]
        err_bl = max(err_bl, check_bl(d, cam, f"pool splat buffer, {key}")[0])
        kw = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
        time_pair("blur_depth" if key == "crop360" else "blur_depth_1080",
                  lambda: kb.blur_depth_kernel(d, cam, **kw),
                  lambda: kb.blur_depth_plain(d, cam, **kw), f"{key} {tuple(d.shape)}")

    # 13. main path: the windowed render path (`render --window auto`): the
    # air-window engine steps, render_frame_buckets draws through kernel X
    reset_launches()
    for _ in range(3):
        state = win.step(state, pool.fluid)
        wimg = frame_to_u8(render_frame_buckets(state, view, rc, bg=bg,
                                                grid_res=win.config.grid_res))
    torch.cuda.synchronize()
    launches_win = kernel_launches()
    if min(launches_win[k] for k in ("extract_cells", "blur_depth", "p2g_update")) <= 0:
        raise AssertionError(f"windowed render did not launch every kernel: {launches_win}")
    if int(state.lost) != lost0 or win.interference != 0:
        raise AssertionError("windowed render: particles lost or window interference")
    phase("render-window", f"3 chunks of 10 substeps + a 640x360 frame each: fluid on "
          f"{fluid_share(wimg, frame_to_u8(bg[0]), rc.crop):.3f} of the crop; "
          f"launches {launches_win}")
    del state, bl_bufs

    # 7. main path: the 1M dam-break, no window
    dam = benchmark_dam_break(N_POOL, device=dev)
    dstep = make_step(dam.config, mode="cuda", substeps=10)
    ds = bucketed.from_simstate(dam.state, dam.config)
    for _ in range(6):  # substep 60: mid-collapse
        ds = dstep(ds, dam.fluid)
    dtimes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ds = dstep(ds, dam.fluid)
        torch.cuda.synchronize()
        dtimes.append(time.perf_counter() - t0)
    if int(ds.lost) != 0 or not bool(torch.isfinite(ds.pos).all()):
        raise AssertionError(f"dam-break: lost={int(ds.lost)} or non-finite")
    dpps = sorted(100 * N_POOL / t for t in dtimes)
    phase("dam", f"{N_POOL} particles, grid {dam.config.grid_res}, windows "
          f"{[round(t, 4) for t in dtimes]} s per 100 substeps -> best "
          f"{dpps[-1] / 1e6:.1f}M median {dpps[1] / 1e6:.1f}M particle-steps/s; "
          f"lost=0 deferred={int(ds.deferred)} [{smi}]")
    del ds

    # 8. CLI
    cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", "fluid_3d", "--frames", "5",
           "--window", "auto"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if (res.returncode != 0 or not re.search(r"^lost: 0 ", res.stdout, re.M)
            or not re.search(r"particle-steps/s on cuda$", res.stdout, re.M)):
        raise AssertionError(f"CLI failed (rc {res.returncode}):\n{res.stdout}\n{res.stderr}")
    phase("cli", " | ".join(res.stdout.strip().splitlines()[-4:]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out:
        cmd = [sys.executable, "-m", "mpm_tpu_torch", "render", "fluid_3d", "--frames", "5",
               "--window", "auto", "--out", out]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        x_launch = re.search(r"extract_cells=(\d+)", res.stdout)
        if (res.returncode != 0 or len(pngs) != 5
                or not re.search(r"particle-steps/s with render on cuda$", res.stdout, re.M)
                or not x_launch or int(x_launch.group(1)) <= 0):
            raise AssertionError(f"render CLI failed (rc {res.returncode}, {len(pngs)} PNGs):"
                                 f"\n{res.stdout}\n{res.stderr}")
    phase("cli-render", " | ".join(res.stdout.strip().splitlines()[-4:]))

    # launches: each kernel's count from the main path that runs it (the
    # pool for P and F, the 640x360 render loop for the emission and BL, the
    # windowed render path for X)
    launches.update({k: launches360[k] for k in ("g2p_migrate_emit", "blur_depth")})
    launches["extract_cells"] = launches_win["extract_cells"]
    src = {"p2g_update": ("mpm_tpu_torch/csrc/p2g_update.cu",
                          "mpm_tpu/ops/pallas/p2g_fused.py:168", err_p),
           "g2p_migrate": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                           "mpm_tpu/ops/pallas/fused.py:387", err_f),
           "g2p_migrate_emit": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                                "mpm_tpu/ops/pallas/fused.py:890", err_fe),
           "extract_cells": ("mpm_tpu_torch/csrc/extract_cells.cu",
                             "mpm_tpu/render/extract_kernel.py:34", err_x),
           "blur_depth": ("mpm_tpu_torch/csrc/blur_depth.cu",
                          "mpm_tpu/render/blur_kernel.py:61", err_bl)}
    kernels = [{"name": k, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[k], "max_abs_err": e,
                "ms": timing[k][0], "plain_ms": timing[k][1]}
               for k, (s, r, e) in src.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
