#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from mpm_tpu_torch/csrc (P, F with its splat emission
and its shard mode, X, BL, SH, the splat kernels (z-buffer and dilation),
the 2D pair sim2d and migrate2d, the per-pass
kernels A, B, D and E, and the two sharded stages of P, one nvcc each, in
parallel), holds each against its plain PyTorch version at full width (P
and F in fixed-point mode too; the shard kernels on every slab of 4),
replays the 3D and 2D golden trajectories through the kernels, runs the
sharded demos on 4 slabs of the card, drives the main paths (the 1M
benchmark pool under the air-window engine; its render loop at 640x360
and at 1080p on the frozen window, the windowed render path, the
velocity, lit-sphere and depth modes and the thickness pass at 640x360
(each frame equal to its chain with the kernels' plain versions) and
1080p, the particle-array renderer, a PNG cubemap, and the sharded
640x360 frames on 4 slabs; the 1M dam-break; the 100k 2D benchmark and
its frame; fluid_3d through the per-pass kernels under MPM_PALLAS_OLD=1;
the fixed-point scene S4; config 5, 16M particles on 256^3 under the air
window on 4 slabs, beside the same window unsharded, and its sharded
frames with the thickness pass), holds the redesigned migration and P2G
passes against their plain versions bit for bit under stress (a config-5
slab as it is, with every slot filled, and under a random grid velocity,
and the card tests' stress cases), holds kernel F with the CLI's spheres
(and an inactive fly-pointer sphere) on the settled pool against its plain
version and steps the pool with a moving sphere, times the pool under the
guard against the bare step and rolls a poisoned run back, runs the
orbit-camera render loop (each frame equal to the plain chain's), runs the
CLI (`--shards 1`, the render flags, and the run-time flags: spheres,
fluid overrides, metrics, checkpoints and resume, the guard, the fly and
orbit cameras and the HUD), runs configs through mode="cuda" against
mode="bucketed" ([route]: the plain engine where the JAX package runs XLA;
the kernels above 32 and above 64 slots a cell on dense scenes, K up to
200, per pass and on 4 slabs too), drives P, F and the 2D pair above 64
slots through mode="cuda" and times them at K = 72 and 128, and P and F
on the same particles at K = 64, 72 and 128 ([wide-k]), holds kernel F and
sim2d with 12 spheres against their plain versions ([inter-many]), runs
the 2D pair on bf16 vel/C ([bf16-2d]), the oracle on the golden replay and
against the binned engine at full size ([oracle]), the binned engine
([binned]), the sort-based sharded step on 4 slabs ([sorted-shard]) and
the CLI's reference, binned and legacy_quad modes ([cli-modes]), checks
the native frame-I/O library on this host and the 1080p `render` CLI's
PNGs through it ([native]), runs the BASELINE ladder's rows 3a and 4a (and
3 and 4 while the run is short; [ladder]), and times each kernel beside
its plain version and its roofline bound (SH and the splat kernels at
the benchmark cell's 1080p crop, where [splat] holds the z-buffer, the
key and the dilation bit for bit against the plain chain). Every main
path runs with the launch counts set to 0 just before it and read just
after. Any failure raises, so the exit code is not 0. The line before the
last is a JSON summary of the kernels; the last line is {"ok": true,
"device": {...}}. Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from mpm_tpu_torch.__main__ import (_camera, _parse_interactions, kernel_launches,
                                    live_particles, nvidia_smi_power)
from mpm_tpu_torch.__main__ import reset_kernel_launches as reset_launches
from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import (benchmark_dam_break, benchmark_scene,
                                         benchmark_scene_2d, dam_break_2d, fluid_3d,
                                         fluid_3d_fixed_point)
from mpm_tpu_torch.ops import bucketed, fixed_point
from mpm_tpu_torch.ops.cuda import build
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import migrate_planes as ke
from mpm_tpu_torch.ops.cuda import p2g_shard as ks
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.cuda import planes as kpl
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.cuda import substep2d as k2d
from mpm_tpu_torch.ops.grid import update_grid
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.parallel.render import demo_sharded_render, make_sharded_frame_step
from mpm_tpu_torch.render import (Camera, RenderConfig, background_for_view, bucket_frame_2d,
                                  default_view, domain_crop, frame_to_u8, load_cubemap,
                                  make_full_frame_step, render_2d, render_frame,
                                  render_frame_buckets, write_png)
from mpm_tpu_torch.render import blur_kernel as kb
from mpm_tpu_torch.render import extract_kernel as kx
from mpm_tpu_torch.render import pipeline as rpipeline
from mpm_tpu_torch.render import shade_kernel as ksh
from mpm_tpu_torch.render import splat as rsplat
from mpm_tpu_torch.render import splat_kernel as ksp
from mpm_tpu_torch.render import ssfr as rssfr
from mpm_tpu_torch.render.flycam import SpherePointer
from mpm_tpu_torch.render.image import read_png_rgb
from mpm_tpu_torch.render.splat import splat_cells, surface_band_uncovered
from mpm_tpu_torch.utils import roofline, wide_k
from mpm_tpu_torch.utils.render_bench import (N_POOL, frame_windows, pool_window, recipe_360,
                                              recipe_1080, settle)
from mpm_tpu_torch.utils.profile_2d import WINDOW_CALLS, warm_bench2d
from mpm_tpu_torch.utils.profile_render_kernels import BL_ARGS, blur_buffers, device_ms
from mpm_tpu_torch.utils.profile_shard import SLABS, check_settled, config5_windows
from mpm_tpu_torch.utils.guard import GuardedStep, state_is_finite
from mpm_tpu_torch.utils.timing import cuda_time_ms, fenced_windows

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_3D = os.path.join(ROOT, "tests", "golden", "fluid_3d_small_bucketed.npz")
GOLDEN_2D = os.path.join(ROOT, "tests", "golden", "dam_break_2d_oracle.npz")
KERNELS = ["p2g_update", "g2p_migrate", "substep2d", "extract_cells", "blur_depth", "planes",
           "p2g_shard", "ssfr_shade", "splat_dilate"]


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


def compare_states(got, want, config, label: str, kname: str = "F") -> float:
    """Kernel F's bars: ids slot for slot, pos atol 1e-6, vel/C atol 1e-5
    (f32) or rtol 0.01 atol 1e-4 (bf16), counters equal (the JAX package's
    bars, tests/test_fused.py; the 2D kernels' are the same f32 bars,
    tests/test_kernels2d.py). Returns the max abs error."""
    if not torch.equal(got.ids, want.ids):
        raise AssertionError(f"kernel {kname} ({label}): ids differ in "
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
            raise AssertionError(f"kernel {kname} ({label}): {name} differs")
    err = max(max_err(got.pos, want.pos), max_err(got.vel, want.vel),
              max_err(got.C, want.C))
    equal = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("pos", "vel", "C"))
    phase(kname, f"{label}: ids equal, max abs err over pos/vel/C={err:.3g}, "
          f"bit-equal={equal}, counters "
          + " ".join(f"{n}={int(getattr(got, n))}" for n in counters))
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


def blur_fsizes(depth, cam):
    """Kernel BL's filter size of each pixel in its X and Y pass at radius
    100 (0 where the pixel passes through)."""
    pc = kb.proj_const_for(cam, BL_ARGS["blur_filter_size"])
    r, dt = BL_ARGS["radius"], BL_ARGS["depth_threshold"]
    bx = kb.blur_pass_plain(depth, 1, r, r, pc, dt)
    return [torch.where((d > 0) & (d <= kb.FAR_GUARD), kb.filter_sizes(d, r, r, pc), 0.0)
            for d in (depth, bx)]


def check_bl(depth, cam, label: str) -> float:
    """Kernel BL vs plain at radius 100: atol 2e-4 rtol 1e-5
    (tests/test_render.py:240). Prints the largest filter size that ran."""
    got = kb.blur_depth_kernel(depth, cam, **BL_ARGS)
    want = kb.blur_depth_plain(depth, cam, **BL_ARGS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
    fmax = max(int(f.max()) for f in blur_fsizes(depth, cam))
    err = max_err(got, want)
    phase("BL", f"{label} {tuple(depth.shape)}: max abs err {err:.3g} (bar atol 2e-4 "
          f"rtol 1e-5), bit-equal={bool(torch.equal(got, want))}, largest fsize {fmax}")
    return err, fmax


def splat_inputs(dev):
    """The splat pass's inputs at the benchmark cell flagship_3d.frame1080:
    kernel X's cell splats of fluid_3d (157,464 particles, 64^3) at
    1920x1080 under its default view, the view, and the render config with
    its domain crop."""
    sc = fluid_3d(device=dev)
    state = bucketed.from_simstate(sc.state, sc.config)
    view = default_view(sc.config.grid_res)
    rc = domain_crop(RenderConfig(camera=Camera(width=1920, height=1080)), sc.config, view)
    return kx.extract_cell_splats(state, view, rc.camera), view, rc


def shade_buffers(dev) -> dict:
    """Kernel SH's arguments at the benchmark cell flagship_3d.frame1080:
    the blurred depth of splat_inputs' splat pass, the procedural sky."""
    cells, view, rc = splat_inputs(dev)
    bg_color, bg_depth = background_for_view(rc, view, dev)
    bufs = splat_cells(cells, rc.camera, sphere_radius=rc.ssfr.particle_sphere_radius,
                       max_radius_px=rc.max_radius_px, crop=rc.crop)
    return dict(fluid_depth=rssfr.blur_depth(bufs.depth, rc.ssfr, rc.camera), bg_color=bg_color,
                bg_depth=bg_depth, cubemap_faces=None, view=view, params=rc.ssfr, cam=rc.camera,
                thickness=None, crop=rc.crop)


def check_sh(kw: dict, label: str):
    """Kernel SH vs plain: `live` identical and the u8 frames more than 1
    level apart on at most 0.01% of the pixels (the benchmark's px_off_pct
    bar). Returns (max abs err, live mask)."""
    got, live = ksh.shade_kernel(**kw)
    want, want_live = ksh.shade_plain(**kw)
    torch.cuda.synchronize()
    if not torch.equal(live, want_live) or int(live.sum()) == 0:
        raise AssertionError(f"kernel SH ({label}): live differs in "
                             f"{int((live != want_live).sum())} pixels, or none is live")
    du8 = (frame_to_u8(got).int() - frame_to_u8(want).int()).abs()
    off = float((du8 > 1).any(dim=-1).float().mean()) * 100
    if off > 0.01:
        raise AssertionError(f"kernel SH ({label}): {off:.4f}% of pixels off by > 1 u8 level")
    err = max_err(got, want)
    phase("SH", f"{label}: {int(live.sum())} live pixels, max abs err {err:.3g}, "
          f"{off:.4f}% off by > 1 u8 level (bar 0.01), bit-equal={bool(torch.equal(got, want))}")
    return err, live


def check_splat(cells, rc):
    """The splat kernels vs the plain chain at the benchmark cell's crop,
    bit for bit: the z-buffer and the dilation (one launch of each), then
    the whole frame's key, z-buffer and the lit mode's tracked dilation
    (depth, velocity, sx, sy). Returns the crop's z-buffer."""
    cam, crop = rc.camera, rc.crop
    r, R = rc.ssfr.particle_sphere_radius, rc.max_radius_px
    n0 = (ksp.zbuffer_launches, ksp.dilate_launches)
    d = rsplat.zbuffer_cells(cells, cam, crop)
    got = rsplat.buffers_from_zbuffer(d, cam, r, R)
    torch.cuda.synchronize()
    launched = (ksp.zbuffer_launches - n0[0], ksp.dilate_launches - n0[1])
    wd = rsplat.zbuffer_cells_plain(cells, cam, crop)
    want = rsplat.buffers_from_zbuffer_plain(wd, cam, r, R)
    lit = rsplat.buffers_from_zbuffer(rsplat.zbuffer_cells(cells, cam), cam, r, R,
                                      key=rsplat.velocity_key(cells, cam), with_normals=True)
    wlit = rsplat.buffers_from_zbuffer_plain(rsplat.zbuffer_cells_plain(cells, cam), cam, r, R,
                                             key=rsplat.velocity_key_plain(cells, cam),
                                             with_normals=True)
    torch.cuda.synchronize()
    same = {"zbuffer": torch.equal(d, wd), "depth": torch.equal(got.depth, want.depth)}
    same.update({f"lit {f}": torch.equal(getattr(lit, f), getattr(wlit, f))
                 for f in ("depth", "velocity", "sx", "sy")})
    covered = int((got.depth < rsplat.BG_DEPTH).sum())
    if launched != (1, 1) or not all(same.values()) or covered == 0:
        raise AssertionError(f"splat kernels at {crop}: launches {launched} (want (1, 1)), "
                             f"bit-equal {same}, {covered} pixels covered")
    phase("splat", f"1920x1080 crop {crop}, R {R}: z-buffer and dilation bit-equal to the plain "
          f"chain ({covered} of {d.numel()} pixels covered), one launch each; the full frame's "
          f"key and lit-mode dilation (depth, velocity, sx, sy) bit-equal too")
    return d


def per_pass_step(config, substeps: int):
    """make_step(mode="cuda") resolved under MPM_PALLAS_OLD=1: the per-pass
    kernels A, B, D and E."""
    os.environ["MPM_PALLAS_OLD"] = "1"
    step = make_step(config, mode="cuda", substeps=substeps)
    del os.environ["MPM_PALLAS_OLD"]
    return step


def check_grid_pair(got: Grid, want: Grid, label: str, kname: str,
                    allow_zero: bool = False) -> float:
    """Kernel P's bar on a grid pair (decoded when fixed point): within 1e-5
    of the largest |value|; an all-zero reference only with `allow_zero`
    (a slab may hold no moving fluid). Returns the max abs error."""
    def dec(t):
        return fixed_point.decode(t, 1e7) if t.dtype == torch.int32 else t

    scale = float(dec(want.mom).abs().max())
    err = max(max_err(dec(got.mom), dec(want.mom)), max_err(dec(got.mass), dec(want.mass)))
    if not (scale > 0 or allow_zero) or err > 1e-5 * scale:
        raise AssertionError(f"kernel {kname} vs plain ({label}): max err {err} > "
                             f"1e-5 * {scale}")
    equal = torch.equal(got.mom, want.mom) and torch.equal(got.mass, want.mass)
    phase(kname, f"{label}: {got.mom.dtype} grid, max|value|={scale:.4g} max abs err={err:.3g} "
          f"(bar 1e-5 * max), bit-equal={equal}")
    return err


def check_planes(state, config, fluid, label: str) -> dict:
    """Kernels A, B and D against their plain versions on one state, D from
    the per-pass grid velocity. Returns the max abs errors by kernel."""
    g1 = kpl.p2g1_planes(state, config)
    w1 = kpl.p2g1_plain(state, config)
    g2 = kpl.p2g2_planes(state, w1.mass, config, fluid)
    w2 = kpl.p2g2_plain(state, w1.mass, config, fluid)
    grid = update_grid(Grid(mom=w1.mom + w2, mass=w1.mass), config, fluid)
    vel, C = kpl.g2p_planes(state, grid, config)
    wvel, wC = kpl.g2p_plain(state, grid, config)
    torch.cuda.synchronize()
    errs = {"p2g1_planes": check_grid_pair(g1, w1, label, "A"),
            "p2g2_planes": check_grid_pair(Grid(mom=g2, mass=w1.mass),
                                           Grid(mom=w2, mass=w1.mass), label, "B")}
    torch.testing.assert_close(vel, wvel, rtol=0, atol=1e-5)
    torch.testing.assert_close(C, wC, rtol=0, atol=1e-5)
    errs["g2p_planes"] = max(max_err(vel, wvel), max_err(C, wC))
    phase("D", f"{label}: vel/C max abs err {errs['g2p_planes']:.3g} (bar 1e-5), bit-equal="
          f"{bool(torch.equal(vel, wvel) and torch.equal(C, wC))}")
    return errs


def check_e(pre, config, label: str) -> float:
    """Kernel E against its plain version at F's bars (moves are copies:
    expected bit-equal); mass equal too."""
    got = ke.migrate_planes(pre, config)
    want = ke.migrate_planes_plain(pre, config)
    torch.cuda.synchronize()
    if not torch.equal(got.mass, want.mass):
        raise AssertionError(f"kernel E ({label}): mass differs")
    return compare_states(got, want, config, label, "E")


def perturbed(state, config, seed: int):
    """A state whose particles move along every axis (uniform +-0.9 cells)
    and, in the cells of even x, y and z of the middle third, all move up
    one cell on each axis, so the phases crowd cells past K."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    occ = state.mass > 0
    d = (torch.rand(tuple(state.pos.shape), generator=gen) * 1.8 - 0.9).to(state.pos.device)
    hi = float(min(config.grid_res)) - 2.5
    pos = torch.clamp(state.pos + torch.where(occ, d, 0.0), 2.0, hi)
    cell = bucketed.cell_coords(config, state.pos.device)
    lo3, hi3 = config.grid_res[0] // 3, 2 * config.grid_res[0] // 3
    push = (cell % 2 == 0).all(dim=0) & (cell >= lo3).all(dim=0) & (cell <= hi3).all(dim=0)
    pos = torch.where(occ & push, torch.floor(state.pos) + 1.5, pos)
    return state.replace(pos=pos.contiguous())


def fluid_share(img, bg_u8, crop) -> float:
    """Share of the crop's pixels where the frame differs from the
    background by more than 2 LSB in some channel."""
    y0, x0, ch, cw = crop
    d = (img.int() - bg_u8.int()).abs().amax(dim=-1)[y0:y0 + ch, x0:x0 + cw]
    return float((d > 2).float().mean())


def phase_2d(dev, smi: str, time_pair):
    """The 2D path: phases 14-18. Returns the two kernels' largest errors
    against their plain versions and the launch counts of the 2D main path."""
    # 14. the 2D kernels against their plain versions, each from one input
    # state: (a) the 2D benchmark at full width (100k, 256^2, K=4) after 20
    # plain substeps, (b) dam_break_2d (64^2, K=8) with the mouse, (c) the
    # crush of tests/test_kernels2d.py after 30 substeps through the kernels
    def check_2d(st, config, fluid, inter, label):
        got = k2d.sim2d(st, config, fluid, inter)
        want = k2d.sim2d_plain(st, config, fluid, inter)
        torch.cuda.synchronize()
        e_sim = compare_states(got, want, config, label, "sim2d")
        got = k2d.migrate2d(want, config)
        want_m = k2d.migrate2d_plain(want, config)
        torch.cuda.synchronize()
        return e_sim, compare_states(got, want_m, config, label, "migrate2d")

    b2 = benchmark_scene_2d(device=dev)
    cfg2, n2 = b2.config, b2.state.num_particles
    s2 = bucketed.from_simstate(b2.state, cfg2)
    for _ in range(20):
        s2 = bucketed.substep(s2, cfg2, b2.fluid)
    errs_2d = [check_2d(s2, cfg2, b2.fluid, (), f"bench2d {cfg2.grid_res} K=4 f32, "
                                               f"{n2} particles, substep 20")]
    d2 = dam_break_2d(device=dev)
    sd = bucketed.from_simstate(d2.state, d2.config)
    sd4 = make_step(d2.config, mode="bucketed", substeps=4)(sd, d2.fluid)
    mouse = (Interaction.mouse((32.0, 20.0), radius=10.0, strength=0.5),)
    errs_2d.append(check_2d(sd4, d2.config, d2.fluid, mouse,
                            f"dam_break_2d {d2.config.grid_res} K=8 with the mouse"))
    crush = dataclasses.replace(d2.fluid, gravity=torch.tensor([0.0, 40.0]))
    sc = make_step(d2.config, mode="cuda", substeps=30)(sd, crush)
    occ = sc.mass > 0
    if (int(sc.lost) != 0 or int(sc.deferred) <= 0 or int(occ.sum()) != d2.state.num_particles
            or int(occ.sum(dim=0).max()) > d2.config.bin_capacity):
        raise AssertionError(f"2D crush: lost {int(sc.lost)} deferred {int(sc.deferred)} "
                             f"max occupancy {int(occ.sum(dim=0).max())}")
    errs_2d.append(check_2d(sc, d2.config, crush, (), f"2D crush after 30 kernel substeps "
                                                      f"(deferred {int(sc.deferred)}, lost 0)"))
    err_sim2d = max(e[0] for e in errs_2d)
    err_mig2d = max(e[1] for e in errs_2d)

    # 15. the 2D golden anchor through the kernels (tests/test_golden.py):
    # K=32, one substep a step, frames of 5 substeps
    data2 = np.load(GOLDEN_2D)
    gcfg2 = d2.config.replace(bin_capacity=32)
    gb = bucketed.from_simstate(d2.state, gcfg2)
    gstep = make_step(gcfg2, mode="cuda", substeps=1)
    for i in range(1, 51):
        gb = gstep(gb, d2.fluid)
        if i in (5, 25, 50):
            got = bucketed.to_simstate(gb).pos.cpu().numpy()
            err = float(np.abs(got - data2[f"pos_f{i // 5}"]).max())
            if not err <= 2e-3 or int(gb.deferred) != 0 or int(gb.lost) != 0:
                raise AssertionError(f"2D golden anchor frame {i // 5}: err {err}, "
                                     f"deferred {int(gb.deferred)}, lost {int(gb.lost)}")
            phase("golden2d", f"frame {i // 5}: max |pos - fixture| = {err:.3g} (bar 2e-3), "
                  "deferred 0")

    # 16. main path: the 2D benchmark, 100k particles on 256^2, K=4, through
    # make_step(mode="cuda"): warm 100 substeps, then 3 fenced windows of
    # 1,000 substeps (utils/profile_2d profiles the same loop)
    _, step2, s2 = warm_bench2d(dev)
    torch.cuda.synchronize()
    reset_launches()
    s2, t2 = fenced_windows(step2, s2, b2.fluid, WINDOW_CALLS)
    launches2d = kernel_launches()
    if int(s2.lost) != 0 or not bool(torch.isfinite(s2.pos).all()):
        raise AssertionError(f"bench2d: lost={int(s2.lost)} or non-finite positions")
    if (min(launches2d["sim2d"], launches2d["migrate2d"]) <= 0
            or launches2d["p2g_update"] or launches2d["g2p_migrate"]):
        raise AssertionError(f"bench2d did not run on the 2D kernels alone: {launches2d}")
    pps2 = sorted(1000 * n2 / t for t in t2)
    phase("bench2d", f"{n2} particles, grid {cfg2.grid_res}, K={cfg2.bin_capacity}, windows "
          f"{[round(t, 4) for t in t2]} s per 1000 substeps ({min(t2):.4f} ms a substep "
          f"best) -> best {pps2[-1] / 1e6:.1f}M "
          f"median {pps2[1] / 1e6:.1f}M particle-steps/s; lost=0 "
          f"deferred={int(s2.deferred)} cfl_clamped={int(s2.cfl_clamped)} "
          f"launches={launches2d} [{smi}]")

    # 17. one 2D frame of the benchmark state on the card (render_2d, 8
    # pixels a cell: 2048x2048 u8); the fluid covers the pool's box
    res2 = cfg2.grid_res
    img2 = frame_to_u8(bucket_frame_2d(s2, res2))
    frame2_ms = cuda_time_ms(lambda: frame_to_u8(bucket_frame_2d(s2, res2)), iters=10)
    empty2 = frame_to_u8(render_2d(torch.zeros((2, 0), device=dev), torch.zeros(0, device=dev),
                                   res2))
    lp = s2.pos[:, s2.mass > 0] * 8
    x0, y0 = (int(v) for v in lp.amin(dim=1))
    x1, y1 = (int(v) for v in lp.amax(dim=1))
    diff2 = (img2.int() - empty2.int()).abs().amax(dim=-1)[y0:y1 + 1, x0:x1 + 1]
    share2 = float((diff2 > 2).float().mean())
    if tuple(img2.shape) != (res2[1] * 8, res2[0] * 8, 3) or share2 < 0.5:
        raise AssertionError(f"2D frame {tuple(img2.shape)}: fluid on {share2:.3f} of the pool")
    phase("frame2d", f"{img2.shape[1]}x{img2.shape[0]} u8 in {frame2_ms:.3f} ms (CUDA events, "
          f"10 frames); fluid on {share2:.3f} of the pool's box {x1 - x0 + 1}x{y1 - y0 + 1} px "
          f"(bar 0.5) [{smi}]")

    # 18. the 2D kernels' times at the benchmark's state, beside their bounds
    s2m = k2d.sim2d(s2, cfg2, b2.fluid)
    time_pair("sim2d", lambda: k2d.sim2d(s2, cfg2, b2.fluid),
              lambda: k2d.sim2d_plain(s2, cfg2, b2.fluid), f"bench2d {res2} K=4",
              roofline.sim2d_work(s2, cfg2))
    time_pair("migrate2d", lambda: k2d.migrate2d(s2m, cfg2),
              lambda: k2d.migrate2d_plain(s2m, cfg2), f"bench2d {res2} K=4",
              roofline.migrate_work(s2m, cfg2))
    return err_sim2d, err_mig2d, launches2d


def phase_per_pass_fixed(dev, smi: str, time_pair):
    """The per-pass path and the fixed-point mode of P and F: phases 19-26.
    Returns the new kernels' largest errors against their plain versions
    and their launch counts on their main paths."""
    # 19. kernels A, B, D and E against their plain versions: fluid_3d at
    # full width (64^3, K=16, f32) after three plain substeps; E on the
    # per-pass path's own input and on a perturbed state that moves along
    # every axis and crowds cells past K
    sc = fluid_3d(device=dev)
    cfg = sc.config
    s3 = bucketed.from_simstate(sc.state, cfg)
    for _ in range(3):
        s3 = bucketed.substep(s3, cfg, sc.fluid)
    label = f"fluid_3d {cfg.grid_res} K=16 f32"
    errs = check_planes(s3, cfg, sc.fluid, label)
    vel, C = kpl.g2p_plain(s3, update_grid(kpl.p2g_planes(s3, cfg, sc.fluid), cfg, sc.fluid),
                           cfg)
    pre = bucketed.advect_tail(s3, vel, C, cfg, sc.fluid)
    crowd = perturbed(s3, cfg, 3)
    errs["migrate_planes"] = max(check_e(pre, cfg, f"{label}, after the tail"),
                                 check_e(crowd, cfg, f"{label}, perturbed"))
    if int(ke.migrate_planes_plain(crowd, cfg).deferred) <= 0:
        raise AssertionError("kernel E's perturbed state deferred no move")

    # 20. fixed-point kernels P and F against their plain versions: S4 (32^3,
    # K=8) after 5 plain substeps and fluid_3d at 64^3 K=16 with
    # fixed_point=True (tests/test_fused.py's way) after 3
    s4 = fluid_3d_fixed_point(device=dev)
    b4 = make_step(s4.config, mode="bucketed", substeps=5)(
        bucketed.from_simstate(s4.state, s4.config), s4.fluid)
    cfgf = cfg.replace(fixed_point=True)
    sf = bucketed.from_simstate(sc.state, cfgf)
    for _ in range(3):
        sf = bucketed.substep(sf, cfgf, sc.fluid)
    err_pf, err_ff = 0.0, 0.0
    for st, c, fl, lab in ((b4, s4.config, s4.fluid, f"S4 {s4.config.grid_res} K=8 fixed"),
                           (sf, cfgf, sc.fluid, f"fluid_3d {cfgf.grid_res} K=16 fixed")):
        want = kp.p2g_update_plain(st, c, fl)
        err_pf = max(err_pf, check_grid_pair(kp.p2g_update(st, c, fl), want, lab, "P-fixed"))
        err_ff = max(err_ff, compare_states(kf.g2p_migrate(st, want, c, fl),
                                            kf.g2p_migrate_plain(st, want, c, fl), c, lab,
                                            "F-fixed"))
    errs["p2g_update_fixed"], errs["g2p_migrate_fixed"] = err_pf, err_ff

    # 21. fixed-point permutation bit-exactness through the kernels: S4 and
    # a permutation of its particles, 3 substeps each, no deferred move
    perm = torch.from_numpy(np.random.default_rng(42).permutation(s4.state.num_particles))
    outs = []
    for st in (s4.state, s4.state.permute(perm.to(dev))):
        b = make_step(s4.config, mode="cuda", substeps=3)(
            bucketed.from_simstate(st, s4.config), s4.fluid)
        if int(b.deferred) != 0 or int(b.lost) != 0:
            raise AssertionError(f"S4 permutation run: deferred {int(b.deferred)}")
        outs.append(bucketed.to_simstate(b))
    for f in ("ids", "pos", "vel", "C"):
        if not torch.equal(getattr(outs[0], f), getattr(outs[1], f)):
            raise AssertionError(f"S4 permuted through the kernels: {f} differs")
    # the decode of the card equals the CPU's x / mult bit for bit
    xs = torch.from_numpy(np.random.default_rng(11).integers(
        -2**31, 2**31 - 1, 1 << 20, dtype=np.int64).astype(np.int32))
    if not torch.equal(fixed_point.decode(xs.to(dev), 1e7).cpu(), fixed_point.decode(xs, 1e7)):
        raise AssertionError("fixed_point.decode on the card differs from the CPU's")
    phase("fixed", f"S4 and a permutation of its {s4.state.num_particles} particles, 3 kernel "
          "substeps: ids, pos, vel and C bit-equal by id, deferred 0; decode of 2^20 int32 "
          "values on the card equals the CPU's")

    # 22. the golden anchor through the per-pass substep (bar 5e-4)
    data = np.load(GOLDEN_3D)
    gs = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=dev)
    gcfg = gs.config.replace(bin_capacity=8)
    gb = bucketed.from_simstate(gs.state, gcfg)
    gstep = per_pass_step(gcfg, 1)
    for i in range(1, 31):
        gb = gstep(gb, gs.fluid)
        if i in (10, 30):
            err = float(np.abs(bucketed.to_simstate(gb).pos.cpu().numpy()
                               - data[f"pos_s{i}"]).max())
            if not err <= 5e-4 or int(gb.lost) != 0:
                raise AssertionError(f"per-pass golden anchor substep {i}: err {err}")
            phase("golden-per-pass", f"substep {i}: max |pos - fixture| = {err:.3g} (bar 5e-4)")

    # 23. main path: fluid_3d (157,464 particles, 64^3, K=16) through the
    # per-pass kernels (MPM_PALLAS_OLD=1), 3 fenced windows of 100 substeps
    n = sc.state.num_particles
    pstep = per_pass_step(cfg, 10)
    st = pstep(s3, sc.fluid)  # warm
    torch.cuda.synchronize()
    reset_launches()
    st, times = fenced_windows(pstep, st, sc.fluid, 10)
    lp = kernel_launches()
    if int(st.lost) != 0 or not bool(torch.isfinite(st.pos).all()):
        raise AssertionError(f"per-pass fluid_3d: lost {int(st.lost)} or non-finite")
    if (min(lp[k] for k in ("p2g1_planes", "p2g2_planes", "g2p_planes", "migrate_planes")) <= 0
            or lp["p2g_update"] or lp["g2p_migrate"]):
        raise AssertionError(f"per-pass fluid_3d did not run on A, B, D and E alone: {lp}")
    pps = sorted(100 * n / t for t in times)
    phase("per-pass", f"fluid_3d {n} particles, grid {cfg.grid_res}, K=16 f32, windows "
          f"{[round(t, 4) for t in times]} s per 100 substeps -> best {pps[-1] / 1e6:.1f}M "
          f"median {pps[1] / 1e6:.1f}M particle-steps/s; lost=0 deferred={int(st.deferred)} "
          f"cfl_clamped={int(st.cfl_clamped)} launches={lp} [{smi}]")

    # 24. the per-pass kernels' times at that state, beside their bounds
    gm = kpl.p2g1_plain(st, cfg).mass
    grid = update_grid(kpl.p2g_planes(st, cfg, sc.fluid), cfg, sc.fluid)
    vel, C = kpl.g2p_planes(st, grid, cfg)
    pre = bucketed.advect_tail(st, vel, C, cfg, sc.fluid)
    shape = f"fluid_3d {cfg.grid_res} K=16 f32"
    time_pair("p2g1_planes", lambda: kpl.p2g1_planes(st, cfg), lambda: kpl.p2g1_plain(st, cfg),
              shape, roofline.p2g1_work(st, cfg))
    time_pair("p2g2_planes", lambda: kpl.p2g2_planes(st, gm, cfg, sc.fluid),
              lambda: kpl.p2g2_plain(st, gm, cfg, sc.fluid), shape, roofline.p2g2_work(st, cfg))
    time_pair("g2p_planes", lambda: kpl.g2p_planes(st, grid, cfg),
              lambda: kpl.g2p_plain(st, grid, cfg), shape, roofline.g2p_work(st, cfg))
    time_pair("migrate_planes", lambda: ke.migrate_planes(pre, cfg),
              lambda: ke.migrate_planes_plain(pre, cfg), shape, roofline.migrate_work(pre, cfg))

    # 25. main path: S4 (4,096 particles, 32^3, K=8, int32 grid) through
    # make_step(mode="cuda"): 3 fenced windows of 100 substeps
    n4 = s4.state.num_particles
    step4 = make_step(s4.config, mode="cuda", substeps=5)
    b4 = step4(bucketed.from_simstate(s4.state, s4.config), s4.fluid)  # warm
    torch.cuda.synchronize()
    reset_launches()
    b4, times4 = fenced_windows(step4, b4, s4.fluid, 20)
    l4 = kernel_launches()
    if int(b4.lost) != 0 or not bool(torch.isfinite(b4.pos).all()):
        raise AssertionError(f"S4: lost {int(b4.lost)} or non-finite")
    if min(l4["p2g_update"], l4["g2p_migrate"]) <= 0 or l4["p2g1_planes"] or l4["migrate_planes"]:
        raise AssertionError(f"S4 did not run on kernels P and F: {l4}")
    pps4 = sorted(100 * n4 / t for t in times4)
    phase("S4", f"fluid_3d_fixed_point {n4} particles, grid {s4.config.grid_res}, K=8, int32 "
          f"grid, windows {[round(t, 4) for t in times4]} s per 100 substeps -> best "
          f"{pps4[-1] / 1e6:.2f}M median {pps4[1] / 1e6:.2f}M particle-steps/s; lost=0 "
          f"deferred={int(b4.deferred)} launches={l4} [{smi}]")

    # 26. fixed-point P and F times at fluid_3d 64^3 K=16 with an int32 grid,
    # beside the float kernels at the float state of the same substep
    g3 = kp.p2g_update(s3, cfg, sc.fluid)
    shape = f"fluid_3d {cfg.grid_res} K=16 f32 (float beside fixed)"
    time_pair("p2g_update_64", lambda: kp.p2g_update(s3, cfg, sc.fluid),
              lambda: kp.p2g_update_plain(s3, cfg, sc.fluid), shape,
              roofline.p2g_update_work(s3, cfg))
    time_pair("g2p_migrate_64", lambda: kf.g2p_migrate(s3, g3, cfg, sc.fluid),
              lambda: kf.g2p_migrate_plain(s3, g3, cfg, sc.fluid), shape,
              roofline.g2p_migrate_work(s3, cfg))
    gf = kp.p2g_update(sf, cfgf, sc.fluid)
    shape = f"fluid_3d {cfgf.grid_res} K=16 fixed"
    time_pair("p2g_update_fixed", lambda: kp.p2g_update(sf, cfgf, sc.fluid),
              lambda: kp.p2g_update_plain(sf, cfgf, sc.fluid), shape,
              roofline.p2g_update_work(sf, cfgf))
    time_pair("g2p_migrate_fixed", lambda: kf.g2p_migrate(sf, gf, cfgf, sc.fluid),
              lambda: kf.g2p_migrate_plain(sf, gf, cfgf, sc.fluid), shape,
              roofline.g2p_migrate_work(sf, cfgf))
    launches = {k: lp[k] for k in ("p2g1_planes", "p2g2_planes", "g2p_planes",
                                   "migrate_planes")}
    launches.update(p2g_update_fixed=l4["p2g_update"], g2p_migrate_fixed=l4["g2p_migrate"])
    return errs, launches


def shard_inputs(state, config, fluid, n: int = SLABS):
    """The padded slabs of a whole-grid state on n slabs of its device, their
    slab config, global offsets and counter gates, and the plain versions'
    exchanged stage-1 grids and grid velocities (so that each kernel is fed
    the same inputs as its plain version)."""
    mesh = domain.SlabMesh.on(state.device, n)
    loc = config.grid_res[0] // n
    pc = config.num_cells // config.grid_res[0]
    padded = domain._exchange_state_halo(domain.shard_bucket_state(state, config, mesh).slabs, pc)
    cfg = bucketed.slab_config(config, loc + 4)
    x0s = [a * loc - 2 for a in range(n)]
    g1 = [ks.p2g1_shard_plain(p, cfg, fluid, x0) for p, x0 in zip(padded, x0s)]
    gm = domain._exchange_grid([g.mass for g in g1], loc, pc)
    g1 = [Grid(mom=g.mom, mass=m) for g, m in zip(g1, gm)]
    gv = domain._exchange_grid([ks.p2g2u_shard_plain(p, g, cfg, fluid, x0)
                                for p, g, x0 in zip(padded, g1, x0s)], loc, pc)
    gates = [bucketed.Slab(x0=x0, go=1, c_lo=2, c_hi=loc + 1) for x0 in x0s]
    return padded, cfg, x0s, g1, [Grid(mom=v, mass=g.mass) for v, g in zip(gv, g1)], gates


def check_shard_kernels(state, config, fluid, rs, label: str) -> dict:
    """The two sharded stages of kernel P and kernel F in shard mode, with
    and without emission, against their plain versions on every slab of
    `state` cut into SLABS slabs: grids at kernel P's bar, states at F's
    (counters included), splats at X's. Returns the max abs errors."""
    padded, cfg, x0s, g1, gv, gates = shard_inputs(state, config, fluid)
    errs = {"p2g1_shard": 0.0, "p2g2u_shard": 0.0, "g2p_migrate_shard": 0.0}
    equal = True
    for a, (p, x0, g, v, gate) in enumerate(zip(padded, x0s, g1, gv, gates)):
        lab = f"{label}, slab {a} of {SLABS} ({cfg.grid_res[0]} planes from x={x0})"
        got1, want1 = ks.p2g1_shard(p, cfg, fluid, x0), ks.p2g1_shard_plain(p, cfg, fluid, x0)
        got2, want2 = ks.p2g2u_shard(p, g, cfg, fluid, x0), ks.p2g2u_shard_plain(p, g, cfg, fluid,
                                                                               x0)
        torch.cuda.synchronize()
        errs["p2g1_shard"] = max(errs["p2g1_shard"], check_grid_pair(got1, want1, lab, "P1-shard",
                                                                     allow_zero=True))
        errs["p2g2u_shard"] = max(errs["p2g2u_shard"], check_grid_pair(
            Grid(mom=got2, mass=g.mass), Grid(mom=want2, mass=g.mass), lab, "P2U-shard",
            allow_zero=True))
        equal = equal and torch.equal(got1.mom, want1.mom) and torch.equal(got1.mass, want1.mass) \
            and torch.equal(got2, want2)
        got = kf.g2p_migrate(p, v, cfg, fluid, slab=gate)
        want = kf.g2p_migrate_plain(p, v, cfg, fluid, slab=gate)
        torch.cuda.synchronize()
        errs["g2p_migrate_shard"] = max(errs["g2p_migrate_shard"],
                                        compare_states(got, want, cfg, lab, "F-shard"))
        got, splats = kf.g2p_migrate(p, v, cfg, fluid, emit_splats=True, render_scals=rs,
                                     slab=gate)
        torch.cuda.synchronize()
        compare_states(got, want, cfg, f"{lab}, emitting", "F-shard")
        serr = compare_splats(splats, kx.cell_splats_plain(want.pos, want.vel, want.mass, rs),
                              f"kernel F shard emission ({lab})")
        errs["g2p_migrate_shard"] = max(errs["g2p_migrate_shard"], serr)
        equal = equal and all(torch.equal(getattr(got, f), getattr(want, f))
                              for f in ("pos", "vel", "C", "mass", "ids"))
    phase("shard-kernels", f"{label}: every slab within the bars; stages and F bit-equal "
          f"to their plain versions: {equal}")
    return errs


def run_config5(dev, smi: str, **kw):
    """Config 5 (BASELINE.md:33: 16M particles on 256^3, sharded): the
    benchmark pool at full size under the air window (headroom 4, chunks
    of 10 substeps) on SLABS slabs of one card, beside the unsharded
    window (utils/profile_shard.config5_windows; `kw` cuts it for a CPU
    rehearsal). Both settle 150 substeps; the gathered sharded state must
    equal the unsharded one bit for bit, with the same wy and counters.
    Then fenced windows of 100 substeps in turns (unsharded, sharded x3,
    unsharded x2), the launch counts read around the sharded ones. Returns
    (launches, the gathered state, its config, the scene's config and the
    fluid)."""
    sc, win_u, win_s = config5_windows(dev, **kw)
    n = sc.state.num_particles
    su, ss = win_u.init(sc.state), win_s.init(sc.state)
    t0 = time.perf_counter()
    su = settle(win_u, su, sc.fluid)
    torch.cuda.synchronize()
    t_u = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss = settle(win_s, ss, sc.fluid)
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    equal = check_settled(win_u, su, win_s, ss)
    phase("config5", f"{n} particles, grid {win_u.true_config.grid_res}, window wy={win_u.wy}, "
          f"K={win_u.config.bin_capacity} {win_u.config.storage_dtype}, {SLABS} slabs of one "
          f"card: 150 settle substeps sharded against unsharded: {equal}; "
          f"settle {t_u:.2f} s unsharded, {t_s:.2f} s sharded")
    tu, ts = [], []
    su, t = fenced_windows(win_u.step, su, sc.fluid, 10, 1)
    tu += t
    reset_launches()
    ss, t = fenced_windows(win_s.step, ss, sc.fluid, 10, 3)
    ts += t
    launches = kernel_launches()
    su, t = fenced_windows(win_u.step, su, sc.fluid, 10, 2)
    tu += t
    if int(ss.lost) != 0 or win_s.interference != 0 or win_u.interference != 0:
        raise AssertionError(f"config 5: lost {int(ss.lost)}, interference "
                             f"{win_s.interference} sharded, {win_u.interference} unsharded")
    if min(launches[k] for k in ("p2g1_shard", "p2g2u_shard", "g2p_migrate_shard")) <= 0 \
            or launches["p2g_update"]:
        raise AssertionError(f"config 5 did not run on the shard kernels alone: {launches}")
    if not all(bool(torch.isfinite(s.pos).all()) for s in ss.slabs):
        raise AssertionError("config 5: non-finite positions")
    pps = sorted(100 * n / t for t in ts)
    ratio = sorted(ts)[1] / sorted(tu)[1]
    phase("config5", f"sharded windows {[round(t, 4) for t in ts]} s per 100 substeps -> "
          f"{min(ts) * 10:.3f} ms a substep best, {sorted(ts)[1] * 10:.3f} median; best "
          f"{pps[-1] / 1e6:.1f}M median {pps[1] / 1e6:.1f}M particle-steps/s; unsharded windows "
          f"{[round(t, 4) for t in tu]} s ({sorted(tu)[1] * 10:.3f} ms a substep median); "
          f"sharded / unsharded = {ratio:.4f} (medians); lost=0 interference=0 wy={win_s.wy} "
          f"launches={launches} [{smi}]")
    shard_launches = {k: launches[k] for k in ("p2g1_shard", "p2g2u_shard", "g2p_migrate_shard")}
    state = domain.gather_bucket_state(ss)
    cfg = win_s.config
    del ss, su
    return shard_launches, state, cfg, sc.config, sc.fluid


STATE_FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def assert_bit_equal(got, want, label: str) -> None:
    differ = [f for f in STATE_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))]
    if differ:
        raise AssertionError(f"{label}: differs from the plain version in {differ}")


def assert_bit_equal_nan(got, want, label: str) -> None:
    """assert_bit_equal for states that hold NaN: a float field NaN where
    the other is NaN, every other value bit for bit."""
    def same(a, b):
        if a.is_floating_point():
            if not torch.equal(a.isnan(), b.isnan()):
                return False
            a, b = (torch.where(x.isnan(), 0.0, x) for x in (a, b))
        return torch.equal(a, b)

    differ = [f for f in STATE_FIELDS if not same(getattr(got, f), getattr(want, f))]
    if differ:
        raise AssertionError(f"{label}: differs from the plain version in {differ}")


def stress_grid(config, fluid, dev, seed: int) -> Grid:
    """A random grid velocity that moves particles up to 1.5 cells a
    substep along every axis (tests/test_torch_cuda.py's stress grid)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    gv = (torch.rand((config.dim, config.num_cells), generator=gen) * 2 - 1) * (
        1.5 / float(fluid.dt))
    if config.fixed_point:
        gv = fixed_point.encode(gv, config.fixed_point_mult)
    return Grid(mom=gv.to(dev).contiguous(), mass=None)


def phase_stress_tests() -> None:
    """The card tests of the migration's choose / move split and of the two
    P2G passes' tiles (tests/test_torch_cuda.py: deferred moves, lost > 0 at
    K=4, the ceiling band, f32, bf16 and fixed point, D = 2 and 3, slabs
    with their counter gate and at both global ends, legacy strain on a
    61 x 53 x 67 grid, K=32 with every slot filled, an empty state, slots
    only in tiles' halo buckets), each bit for bit its plain version."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
           os.path.join(ROOT, "tests", "test_torch_cuda.py"), "-k", "stress or odd_grid"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    if res.returncode != 0 or " passed" not in last or "failed" in last or "skipped" in last:
        raise AssertionError(f"stress card tests failed (rc {res.returncode}):\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-2000:]}")
    phase("stress", f"tests/test_torch_cuda.py -k 'stress or odd_grid': {last}")


def phase_shard_times(state, config, fluid, time_pair) -> None:
    """The shard kernels' times on slab 1 of config 5's settled window,
    beside their plain versions and bounds (utils/roofline.py); before
    them, the two stages and F's shard mode on that slab bit for bit their
    plain versions, stage 1 also with every slot off the y and z edge planes
    filled (the empty slots given mass at their cell centres), F also under
    a random grid velocity that defers moves and counts on the slab's own
    planes only."""
    padded, cfg, x0s, g1, gv, gates = shard_inputs(state, config, fluid)
    p, x0, g, v, gate = padded[1], x0s[1], g1[1], gv[1], gates[1]
    shape = f"config 5 slab 1 of {SLABS}: {cfg.grid_res} K={cfg.bin_capacity} bf16"
    # the empty slots of every cell off the y and z edge planes (which the
    # clamps keep empty, and where the plain version's flat offsets wrap
    # rows) filled at their cell centres
    co = bucketed.cell_coords(cfg, p.device, x0=x0)  # [3, C]
    fill = (p.mass <= 0) & ((co[1] >= 1) & (co[1] <= cfg.grid_res[1] - 2) & (co[2] >= 1)
                            & (co[2] <= cfg.grid_res[2] - 2))[None, :]
    full = p.replace(pos=torch.where(fill, co[:, None, :] + 0.5, p.pos).contiguous(),
                     mass=torch.where(fill, torch.ones_like(p.mass), p.mass))
    for label, st in (("as it is", p), ("every slot off the y and z edges filled", full)):
        got, want = ks.p2g1_shard(st, cfg, fluid, x0), ks.p2g1_shard_plain(st, cfg, fluid, x0)
        if not (torch.equal(got.mass, want.mass) and torch.equal(got.mom, want.mom)):
            raise AssertionError(f"p2g1_shard differs from its plain version at {shape}, {label}")
    phase("stress", f"{shape}: p2g1_shard bit-equal to its plain version with "
          f"{int((p.mass > 0).sum())} and with {int((full.mass > 0).sum())} of "
          f"{p.mass.numel()} slots occupied")
    del full, fill, co, got, want
    if not torch.equal(ks.p2g2u_shard(p, g, cfg, fluid, x0),
                       ks.p2g2u_shard_plain(p, g, cfg, fluid, x0)):
        raise AssertionError(f"p2g2u_shard differs from its plain version at {shape}")
    assert_bit_equal(kf.g2p_migrate(p, v, cfg, fluid, slab=gate),
                     kf.g2p_migrate_plain(p, v, cfg, fluid, slab=gate), f"F shard mode, {shape}")
    rand = stress_grid(bucketed.slab_config(cfg, cfg.grid_res[0] + 2), fluid, p.pos.device, 17)
    want = kf.g2p_migrate_plain(p, rand, cfg, fluid, slab=gate)
    assert_bit_equal(kf.g2p_migrate(p, rand, cfg, fluid, slab=gate), want,
                     f"F shard mode under a random grid velocity, {shape}")
    if int(want.deferred) <= 0:
        raise AssertionError("the random grid velocity deferred no move")
    phase("stress", f"{shape}: p2g2u_shard and F's shard mode bit-equal to their plain "
          f"versions; under a random grid velocity too (own planes {gate.c_lo}-{gate.c_hi}: "
          + " ".join(f"{n}={int(getattr(want, n))}" for n in STATE_FIELDS[5:]) + ")")
    del rand, want
    time_pair("p2g1_shard", lambda: ks.p2g1_shard(p, cfg, fluid, x0),
              lambda: ks.p2g1_shard_plain(p, cfg, fluid, x0), shape,
              roofline.p2g1_shard_work(p, cfg))
    time_pair("p2g2u_shard", lambda: ks.p2g2u_shard(p, g, cfg, fluid, x0),
              lambda: ks.p2g2u_shard_plain(p, g, cfg, fluid, x0), shape,
              roofline.p2g2u_shard_work(p, cfg))
    time_pair("g2p_migrate_shard", lambda: kf.g2p_migrate(p, v, cfg, fluid, slab=gate),
              lambda: kf.g2p_migrate_plain(p, v, cfg, fluid, slab=gate), shape,
              roofline.g2p_migrate_work(p, cfg))


MODES = [("velocity_spheres", {}), ("lit_spheres", {}), ("depth_debug", {}),
         ("default", {"thickness_pass": True})]


def with_mode(rc, mode: str, **ssfr_kw):
    return dataclasses.replace(rc, mode=mode, ssfr=dataclasses.replace(rc.ssfr, **ssfr_kw))


@contextlib.contextmanager
def plain_chain():
    """The render chain with the plain versions of its kernels on the card:
    the substeps through P's and F's plain versions, the emission through
    the per-cell plain code, the z-buffer, key and dilation through the
    plain splat pass, the blur through BL's plain version, the shade
    through SH's."""
    saved = (cuda_step.substep, cuda_step.substep_emit, rssfr.blur_depth_kernel,
             rpipeline.shade_kernel, rsplat.zbuffer_cells, rsplat.velocity_key,
             rsplat.buffers_from_zbuffer)

    def substep(state, config, fp, inter=()):
        return kf.g2p_migrate_plain(state, kp.p2g_update_plain(state, config, fp), config, fp,
                                    inter)

    def substep_emit(state, config, fp, inter, rs):
        out = substep(state, config, fp, inter)
        return out, kx.cell_splats_plain(out.pos, out.vel, out.mass, rs)

    cuda_step.substep, cuda_step.substep_emit = substep, substep_emit
    rssfr.blur_depth_kernel = kb.blur_depth_plain
    rpipeline.shade_kernel = ksh.shade_plain
    rsplat.zbuffer_cells = rsplat.zbuffer_cells_plain
    rsplat.velocity_key = rsplat.velocity_key_plain
    rsplat.buffers_from_zbuffer = rsplat.buffers_from_zbuffer_plain
    try:
        yield
    finally:
        (cuda_step.substep, cuda_step.substep_emit, rssfr.blur_depth_kernel,
         rpipeline.shade_kernel, rsplat.zbuffer_cells, rsplat.velocity_key,
         rsplat.buffers_from_zbuffer) = saved


def mean_du8(a, b) -> float:
    return float((a.int() - b.int()).abs().float().mean())


def phase_render_modes(dev, smi: str, state, cfgw, pool, view):
    """Every render mode at 640x360 on the frozen settled window, cell
    quality (the crop for the default chain only): velocity_spheres,
    lit_spheres, depth_debug and default with the thickness pass. For each:
    the kernel path's frame equals the plain chain's bit for bit and a
    second call's, fluid on at least 1% of the frame (the thickness frame
    also more than 0.1 mean |du8| from the constant one), then 3 windows of
    40 frames from the same state with the launch counts read around them
    (the state they end in is dropped, so the later phases start where this
    one did). Returns the emission's, BL's, SH's and the splat kernels'
    launches over the windows."""
    subs = pool.config.substeps
    rc0 = recipe_360(pool.config, view)
    bg = background_for_view(rc0, view, dev)
    bg_u8 = frame_to_u8(bg[0])
    _, const = make_full_frame_step(cfgw, rc0, subs)(state, pool.fluid, (), view, bg)
    full = (0, 0, rc0.camera.height, rc0.camera.width)
    total = {"g2p_migrate_emit": 0, "blur_depth": 0, "ssfr_shade": 0, "splat_zbuffer": 0,
             "splat_dilate": 0}
    lost0 = int(state.lost)
    for mode, kw in MODES:
        rc = with_mode(rc0, mode, **kw)
        frame = make_full_frame_step(cfgw, rc, subs)
        s1, img = frame(state, pool.fluid, (), view, bg)
        _, again = frame(state, pool.fluid, (), view, bg)
        with plain_chain():
            s2, plain = frame(state, pool.fluid, (), view, bg)
        if not torch.equal(img, plain) or not torch.equal(img, again):
            raise AssertionError(f"{mode}: the kernel path's frame differs from the plain chain's "
                                 f"in {int((img != plain).any(dim=-1).sum())} pixels, from a "
                                 f"second call's in {int((img != again).any(dim=-1).sum())}")
        if not all(torch.equal(getattr(s1, f), getattr(s2, f)) for f in STATE_FIELDS):
            raise AssertionError(f"{mode}: the kernel path's state differs from the plain chain's")
        if mode == "depth_debug":  # the depth view draws the background white
            share = float((img < 255).any(dim=-1).float().mean())
        else:
            share = fluid_share(img, bg_u8, rc.crop if mode == "default" else full)
        if share < 0.01:
            raise AssertionError(f"{mode}: fluid on only {share:.4f} of the frame")
        extra = ""
        if kw.get("thickness_pass"):
            du8 = mean_du8(img, const)
            if not du8 > 0.1:
                raise AssertionError(f"the thickness frame is {du8:.4f} mean |du8| from the "
                                     "constant-thickness frame (bar > 0.1)")
            extra = f"; {du8:.4f} mean |du8| from the constant-thickness frame (bar > 0.1)"
        reset_launches()
        end, img, times = frame_windows(frame, state, pool.fluid, view, bg, 40, 3)
        launches = kernel_launches()
        ran = ["g2p_migrate_emit", "splat_zbuffer", "splat_dilate"]
        ran += ["blur_depth"] if mode in ("default", "depth_debug") else []
        ran += ["ssfr_shade"] if mode == "default" else []
        if min(launches[k] for k in ran) <= 0:
            raise AssertionError(f"{mode} did not launch {ran}: {launches}")
        for k in total:
            total[k] += launches[k]
        if int(end.lost) != lost0 or int(end.ceiling) != 0:
            raise AssertionError(f"{mode}: lost {int(end.lost) - lost0}, ceiling "
                                 f"{int(end.ceiling)}")
        phase("render360-" + mode, f"{kw or ''} the kernel path's frame equals the plain "
              f"chain's and a second call's bit for bit; fluid on {share:.3f} of the "
              f"{'crop' if mode == 'default' else 'frame'}{extra}; windows "
              f"{[round(t, 4) for t in times]} s per 40 frames -> {min(times) / 40 * 1e3:.3f} "
              f"ms/frame best, {sorted(times)[1] / 40 * 1e3:.3f} median; launches "
              f"{ {k: launches[k] for k in ran} } [{smi}]")
    return total


def phase_thickness_1080(dev, smi: str, state, cfgw, pool, view):
    """The 1080p recipe (particle quality, bands, R=8) with the thickness
    pass: 2 windows of 10 frames, band certificate 0."""
    subs = pool.config.substeps
    rc = recipe_1080(pool.config, state, cfgw.grid_res, view)
    rc = with_mode(rc, "default", thickness_pass=True)
    bg = background_for_view(rc, view, dev)
    frame = make_full_frame_step(cfgw, rc, subs)
    lost0 = int(state.lost)
    state, _ = frame(state, pool.fluid, (), view, bg)  # warm
    reset_launches()
    state, img, times = frame_windows(frame, state, pool.fluid, view, bg, 10, 2)
    launches = kernel_launches()
    unc = surface_band_uncovered(state, cfgw.grid_res, rc.surface_bands)
    if int(state.lost) != lost0 or int(state.ceiling) != 0 or unc != 0:
        raise AssertionError(f"1080p thickness: lost {int(state.lost) - lost0}, ceiling "
                             f"{int(state.ceiling)}, band certificate {unc}")
    if min(launches[k] for k in ("g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"1080p thickness did not launch every kernel: {launches}")
    share = fluid_share(img, frame_to_u8(bg[0]), rc.crop)
    if share < 0.1:
        raise AssertionError(f"1080p thickness: fluid on only {share:.3f} of the crop")
    phase("render1080-thickness", f"bands {rc.surface_bands}, crop {rc.crop}, windows "
          f"{[round(t, 4) for t in times]} s per 10 frames -> {min(times) / 10 * 1e3:.3f} "
          f"ms/frame best; lost 0 ceiling 0 band certificate 0; fluid on {share:.3f} of the "
          f"crop [{smi}]")
    return state


def phase_sharded_modes(dev, smi: str, state, cfgw, pool, view) -> None:
    """640x360 on SLABS slabs of the card: velocity_spheres equals the
    single-device frame bit for bit (min composites); the thickness frame
    (sum composite) is within a mean |du8| of 0.5 of it and the same bits on
    a second call."""
    subs = pool.config.substeps
    rc0 = recipe_360(pool.config, view)
    bg = background_for_view(rc0, view, dev)
    mesh = domain.SlabMesh.on(dev, SLABS)
    sb = domain.shard_bucket_state(state, cfgw, mesh)
    out = []
    for mode, kw in (("velocity_spheres", {}), ("default", {"thickness_pass": True})):
        rc = with_mode(rc0, mode, **kw)
        sframe = make_sharded_frame_step(cfgw, mesh, rc, subs)
        ss, img = sframe(sb, pool.fluid, (), view, bg)
        _, again = sframe(sb, pool.fluid, (), view, bg)
        _, want = make_full_frame_step(cfgw, rc, subs)(state, pool.fluid, (), view, bg)
        if int(ss.lost) != int(state.lost) or int(ss.ceiling) != 0:
            raise AssertionError(f"sharded {mode}: particles lost or a ceiling hit")
        if not torch.equal(img, again):
            raise AssertionError(f"sharded {mode}: two calls differ")
        du8 = mean_du8(img, want)
        if mode == "velocity_spheres" and not torch.equal(img, want):
            raise AssertionError(f"sharded velocity_spheres differs from the single-device frame "
                                 f"in {int((img != want).any(dim=-1).sum())} pixels")
        if not du8 < 0.5:
            raise AssertionError(f"sharded {mode}: {du8:.4f} mean |du8| from the single-device "
                                 "frame (bar 0.5)")
        out.append(f"{mode}{' thickness' if kw else ''}: {du8:.5f} mean |du8| from the "
                   f"single-device frame, {int((img != want).any(dim=-1).sum())} pixels differ")
    phase("render360-sharded-modes", f"{SLABS} slabs; " + "; ".join(out)
          + "; each the same bits on a second call")


def phase_config5_render(dev, smi: str, s5, cfg5, true_cfg5, fluid5) -> None:
    """Config 5's render clause (BASELINE.md:33): sharded 640x360 frames
    with the thickness pass on the config-5 window (SLABS slabs): 1 warm and
    3 timed frames, lost 0, ceiling 0."""
    view = default_view(true_cfg5.grid_res)
    rc = with_mode(recipe_360(true_cfg5, view), "default", thickness_pass=True)
    bg = background_for_view(rc, view, dev)
    mesh = domain.SlabMesh.on(dev, SLABS)
    sframe = make_sharded_frame_step(cfg5, mesh, rc, true_cfg5.substeps)
    ss = domain.shard_bucket_state(s5, cfg5, mesh)
    lost0 = int(s5.lost)
    ss, _ = sframe(ss, fluid5, (), view, bg)
    reset_launches()
    ss, img, times = frame_windows(sframe, ss, fluid5, view, bg, 3, 1)
    launches = kernel_launches()
    if int(ss.lost) != lost0 or int(ss.ceiling) != 0:
        raise AssertionError(f"config 5 render: lost {int(ss.lost) - lost0}, ceiling "
                             f"{int(ss.ceiling)}")
    if min(launches[k] for k in ("p2g1_shard", "g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"config 5 render did not launch every kernel: {launches}")
    crop = rc.crop or (0, 0, rc.camera.height, rc.camera.width)
    share = fluid_share(img, frame_to_u8(bg[0]), crop)
    if share < 0.01:
        raise AssertionError(f"config 5 render: fluid on only {share:.4f} of {crop}")
    phase("config5-render", f"{s5.pos.shape[1] * s5.pos.shape[2]} slots, window "
          f"{cfg5.grid_res}, {SLABS} slabs, 640x360 with the thickness pass, {true_cfg5.substeps} "
          f"substeps a frame: {times[0] / 3 * 1e3:.3f} ms/frame over 3 frames; lost 0 ceiling 0; "
          f"fluid on {share:.3f} of {crop}; launches {launches} [{smi}]")


def write_gradient_faces(d: str) -> None:
    """Six 64x64 gradient cubemap faces `sky-1.png .. sky-6.png` in `d`."""
    ramp = np.linspace(0, 255, 64).astype(np.uint8)
    for i in range(1, 7):
        face = np.stack([np.broadcast_to(ramp[:, None], (64, 64)),
                         np.full((64, 64), 40 * i, np.uint8),
                         np.broadcast_to(ramp[None, ::-1], (64, 64))], -1)
        write_png(os.path.join(d, f"sky-{i}.png"), np.ascontiguousarray(face))


def phase_particles_and_cubemap(dev, smi: str, state, cfgw, pool, view) -> None:
    """render_frame at sphere_render_ratio 0.5 on the pool's live slots (the
    particle-array path), one frame and its time; then six 64x64 gradient
    faces written as PNGs, read back by load_cubemap, and the frame of the
    cubemap against the sky's."""
    rc = RenderConfig(camera=Camera(width=640, height=360), sphere_render_ratio=0.5)
    bg = background_for_view(rc, view, dev)
    pos, vmag = live_particles(state)
    reset_launches()
    img = frame_to_u8(render_frame(pos, vmag, view, rc, bg=bg))
    torch.cuda.synchronize()
    if kernel_launches()["blur_depth"] <= 0:
        raise AssertionError("the particle-array frame did not launch kernel BL")
    ms = cuda_time_ms(lambda: render_frame(pos, vmag, view, rc, bg=bg), iters=5)
    share = fluid_share(img, frame_to_u8(bg[0]), (0, 0, 360, 640))
    if share < 0.01:
        raise AssertionError(f"particle-array frame: fluid on only {share:.4f} of the frame")
    phase("particles", f"render_frame of {int((state.mass > 0).sum())} live slots at ratio 0.5, "
          f"640x360: {ms:.3f} ms a frame (CUDA events, 5 calls); fluid on {share:.3f} of the "
          f"frame [{smi}]")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cubemap_") as d:
        write_gradient_faces(d)
        faces = load_cubemap(d, dev)
    rc0 = recipe_360(pool.config, view)
    bg0 = background_for_view(rc0, view, dev)
    _, sky = make_full_frame_step(cfgw, rc0, pool.config.substeps)(state, pool.fluid, (), view, bg0)
    _, cube = make_full_frame_step(cfgw, rc0, pool.config.substeps, cubemap_faces=faces)(
        state, pool.fluid, (), view, bg0)
    du8 = mean_du8(cube, sky)
    if tuple(faces.shape) != (6, 64, 64, 3) or not du8 > 0:
        raise AssertionError(f"cubemap: faces {tuple(faces.shape)}, {du8} mean |du8| from the "
                             "sky frame")
    phase("cubemap", f"6 faces {tuple(faces.shape)} from PNG on {faces.device}; the 640x360 "
          f"frame is {du8:.4f} mean |du8| from the sky frame")


def run_cli(args, label: str, out: str, frames: int, want: tuple) -> None:
    """`python -m mpm_tpu_torch render ...`: rc 0, one PNG a frame, and each
    kernel of `want` launched."""
    cmd = [sys.executable, "-m", "mpm_tpu_torch", "render", *args, "--frames", str(frames),
           "--out", out]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    pngs = [f for f in os.listdir(out) if f.endswith(".png")] if os.path.isdir(out) else []
    counts = {k: re.search(rf"\b{k}=(\d+)", res.stdout) for k in want}
    if res.returncode != 0 or len(pngs) != frames or not all(
            c and int(c.group(1)) > 0 for c in counts.values()):
        raise AssertionError(f"render {' '.join(args)} failed (rc {res.returncode}, {len(pngs)} "
                             f"PNGs):\n{res.stdout}\n{res.stderr}")
    phase(label, " | ".join(res.stdout.strip().splitlines()[-4:]))
    return res.stdout



def phase_interactions(dev, smi: str, state, cfgw, win, pool) -> float:
    """Kernel F's interaction branch on the settled pool window (bf16,
    K=8): the two static spheres and the orbit sphere of frame 7, then the
    same with the fly pointer's sphere inactive, each bit-equal to F's plain
    version (the inactive sphere changes no bit, the three spheres do
    push); then 10 chunks of 10 substeps of the window with the orbit
    sphere moving each chunk, lost 0, interference 0, launch counts read
    around them. Returns F's max abs error."""
    # the CLI's --interact sphere=32,10,32,6 (in the fluid) and
    # sphere=8,70,56,5,0.5 (above it) with --orbit-sphere
    args = argparse.Namespace(interact=["sphere=32,10,32,6", "sphere=8,70,56,5,0.5"],
                              orbit_sphere=True)
    inter_fn = _parse_interactions(args, pool.config)[1]
    three = inter_fn(7)
    four = three + (SpherePointer(pool.config).interaction(),)
    grid = kp.p2g_update_plain(state, cfgw, pool.fluid)
    outs, err = [], 0.0
    for inter, label in ((three, "3 spheres"), (four, "3 spheres + the inactive fly pointer")):
        got = kf.g2p_migrate(state, grid, cfgw, pool.fluid, inter)
        want = kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid, inter)
        torch.cuda.synchronize()
        err = max(err, compare_states(got, want, cfgw, f"settled pool window {cfgw.grid_res} "
                                      f"K=8 bf16, {label}"))
        assert_bit_equal(got, want, f"kernel F with {label}")
        outs.append(got)
    assert_bit_equal(outs[1], outs[0], "kernel F with the inactive fly pointer")
    # a NaN position in one live slot and the grid P's plain version makes
    # from it: F and its plain version clamp it into the domain and keep it,
    # the NaN left in vel and C
    bad = poison(state)
    bad_grid = kp.p2g_update_plain(bad, cfgw, pool.fluid)
    got = kf.g2p_migrate(bad, bad_grid, cfgw, pool.fluid, three)
    want = kf.g2p_migrate_plain(bad, bad_grid, cfgw, pool.fluid, three)
    assert_bit_equal_nan(got, want, "kernel F on a NaN position")
    nan_slots = int((~want.vel.isfinite()).any(dim=0).sum())
    if (not bool(want.pos.isfinite().all()) or nan_slots == 0
            or int((want.mass > 0).sum()) != int((bad.mass > 0).sum())
            or int(want.lost) != int(bad.lost)):
        raise AssertionError("kernel F on a NaN position: the particle was not kept")
    del bad, bad_grid, got, want
    bare = kf.g2p_migrate(state, grid, cfgw, pool.fluid)
    pushed = int((bare.vel != outs[0].vel).any(dim=0).sum())
    if pushed == 0:
        raise AssertionError("kernel F: the three spheres pushed no slot")
    lost0, hits0 = int(state.lost), win.interference
    reset_launches()
    s = state
    for i in range(10):
        s = win.step(s, pool.fluid, inter_fn(i))
    torch.cuda.synchronize()
    launches = kernel_launches()
    if min(launches[k] for k in ("p2g_update", "g2p_migrate")) <= 0:
        raise AssertionError(f"the orbit-sphere chunks did not launch P and F: {launches}")
    if int(s.lost) != lost0 or win.interference != hits0 or not state_is_finite(s):
        raise AssertionError(f"orbit sphere: lost {int(s.lost) - lost0}, interference "
                             f"{win.interference - hits0}")
    phase("F-interact", f"3 spheres and 3 + the inactive pointer bit-equal to plain; the "
          f"inactive sphere changes no bit; the spheres push {pushed} slots; a NaN position "
          f"bit-equal to plain (NaN where NaN), kept, NaN in {nan_slots} slots' vel; 100 substeps "
          f"with the orbit sphere moving every 10: lost 0 interference 0 window wy={win.wy}; "
          f"launches P={launches['p2g_update']} F={launches['g2p_migrate']} [{smi}]")
    return err


def poison(state):
    """A NaN in one live slot's position."""
    k, c = np.unravel_index(int(torch.argmax(state.mass)), tuple(state.mass.shape))
    pos = state.pos.clone()
    pos[0, int(k), int(c)] = float("nan")
    return state.replace(pos=pos)


def phase_guard(dev, smi: str, state, win, pool) -> None:
    """GuardedStep(snapshot_every=32, check_every=8) around the pool
    window's 10-substep chunks against the bare window step: fenced windows
    of 32 chunks, bare and guarded in turns, 3 of each, after one guarded
    warm-up chunk; then a step that poisons pos with a NaN at call 20:
    the guard rolls back once to a verified snapshot, halves dt, and its
    last good state is finite."""
    lost0 = int(state.lost)
    guarded = GuardedStep(win.step, snapshot_every=32, check_every=8)
    state = guarded(state, pool.fluid)
    times = {"bare": [], "guarded": []}
    for _ in range(3):
        for name, fn in (("bare", win.step), ("guarded", guarded)):
            state, t = fenced_windows(fn, state, pool.fluid, 32, 1)
            times[name] += t
    if not guarded.flush() or guarded.failures or int(state.lost) != lost0:
        raise AssertionError(f"guard on a healthy pool: failures {guarded.failures}")
    bare, guard = (sorted(times[k])[1] for k in ("bare", "guarded"))
    calls = {"n": 0}

    def flaky(s, fp, inter=()):
        calls["n"] += 1
        out = win.step(s, fp, inter)
        return poison(out) if calls["n"] == 20 else out

    g = GuardedStep(flaky, snapshot_every=32, check_every=8)
    s = state
    for _ in range(40):
        s = g(s, pool.fluid)
    if not g.flush():
        s = g.last_good()
    if (g.failures != 1 or g.current_dt_scale != 0.5 or not state_is_finite(g.last_good())
            or not state_is_finite(s)):
        raise AssertionError(f"guard rollback: failures {g.failures}, dt scale "
                             f"{g.current_dt_scale}, last good finite "
                             f"{state_is_finite(g.last_good())}")
    phase("guard", f"pool window, 10 substeps a call, GuardedStep(snapshot_every=32, "
          f"check_every=8): windows of 32 calls, bare {[round(t, 4) for t in times['bare']]} s, "
          f"guarded {[round(t, 4) for t in times['guarded']]} s; medians {bare:.4f} / "
          f"{guard:.4f} s -> ratio {guard / bare:.4f}; NaN in pos at call 20: failures 1, dt "
          f"scale 0.5, {g.frames_lost} frames lost, the last good state finite [{smi}]")


def phase_moving_camera(dev, smi: str, state, cfgw, pool, view) -> None:
    """The default-mode full-frame loop at 640x360 under the CLI's
    --orbit-camera (`_camera`, one orbit in 120 frames): no crop, the
    background traced every frame. 12 frames with views 10 frames apart,
    each frame and state equal to the plain chain's bit for bit; then
    windows of 40 frames, the static loop (traced background, crop) and the
    moving one in turns, 3 of each."""
    subs = pool.config.substeps
    args = argparse.Namespace(fly=False, fly_script=None, orbit_camera=True, frames=120)
    view_fn = _camera(args, pool)[0]
    rc = RenderConfig(camera=Camera(width=640, height=360))
    frame = make_full_frame_step(cfgw, rc, subs)
    sk = sp = state
    first = img = None
    for i in range(12):
        v = view_fn(10 * i)
        sk, img = frame(sk, pool.fluid, (), v, None)
        with plain_chain():
            sp, plain = frame(sp, pool.fluid, (), v, None)
        if not torch.equal(img, plain):
            raise AssertionError(f"orbit frame {10 * i}: the kernel path's frame differs from "
                                 f"the plain chain's in {int((img != plain).any(-1).sum())} px")
        assert_bit_equal(sk, sp, f"orbit frame {10 * i}: the kernel path's state")
        first = img if first is None else first
    du8 = mean_du8(first, img)
    if not du8 > 1.0:
        raise AssertionError(f"orbit camera: first and last frames {du8:.3f} mean |du8| apart")
    rc0 = recipe_360(pool.config, view)
    bg = background_for_view(rc0, view, dev)
    static = make_full_frame_step(cfgw, rc0, subs)
    lost0 = int(state.lost)
    times = {"static": [], "moving": []}
    launches = {}
    for _ in range(3):
        state, _, t = frame_windows(static, state, pool.fluid, view, bg, 40, 1)
        times["static"] += t
        reset_launches()
        state, _, t = frame_windows(frame, state, pool.fluid, view_fn, None, 40, 1)
        times["moving"] += t
        launches = kernel_launches()
    if min(launches[k] for k in ("g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"the orbit loop did not launch F-emit and BL: {launches}")
    if int(state.lost) != lost0 or int(state.ceiling) != 0:
        raise AssertionError("orbit loop: particles lost or a ceiling hit")
    ms = {k: sorted(v)[1] / 40 * 1e3 for k, v in times.items()}
    phase("render360-orbit", f"12 orbit frames 10 apart equal the plain chain's bit for bit "
          f"(states too), first to last {du8:.3f} mean |du8|; windows of 40 frames, static "
          f"{[round(t, 4) for t in times['static']]} s, orbit "
          f"{[round(t, 4) for t in times['moving']]} s -> median {ms['static']:.3f} ms/frame "
          f"static (crop {rc0.crop}), {ms['moving']:.3f} orbiting (no crop, background "
          f"traced every frame); launches {launches} [{smi}]")


def phase_cli_runtime() -> None:
    """The CLI's run-time flags on the card: `run` with the interactions,
    fluid overrides, metrics, checkpoints and the guard; resume with and
    without the window; `render` with a scripted flight and the orbit
    camera (the HUD on both); the 2D render with a sphere."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_runtime_") as tmp:
        ck, met = os.path.join(tmp, "ck"), os.path.join(tmp, "m.jsonl")

        def run(args, label):
            cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", "fluid_3d", *args]
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            if res.returncode != 0 or not re.search(r"^lost: 0 ", res.stdout, re.M):
                raise AssertionError(f"run {' '.join(args)} failed (rc {res.returncode}):\n"
                                     f"{res.stdout}\n{res.stderr}")
            phase(label, " | ".join(res.stdout.strip().splitlines()[-4:]))
            return res.stdout

        run(["--window", "auto", "--frames", "12", "--interact", "sphere=32,10,32,6",
             "--orbit-sphere", "--fluid", "dt=0.15", "--flip-gravity-at", "6", "--metrics", met,
             "--checkpoint-every", "6", "--checkpoint-dir", ck, "--guard"], "cli-run-runtime")
        with open(met) as f:
            events = [json.loads(line)["event"] for line in f]
        npz = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
        if not {"compile", "frame", "guard", "counters", "summary"} <= set(events) or npz != [
                "frame_00006.npz", "frame_00012.npz"]:
            raise AssertionError(f"run: metrics events {events}, checkpoints {npz}")
        phase("cli-run-runtime", f"metrics events {sorted(set(events))} ({len(events)} "
              f"records), checkpoints {npz}")
        for window in (["--window", "auto"], []):
            out = run(["--resume", os.path.join(ck, "frame_00012.npz"), "--frames", "3",
                       *window], "cli-resume" + ("-window" if window else ""))
            if "resumed from" not in out:
                raise AssertionError(f"resume did not resume:\n{out}")
        for args, label, frames in ((["--fly-script", "w:4,wp:4,l:4"], "cli-render-fly", 12),
                                    (["--orbit-camera"], "cli-render-orbit", 6)):
            out = os.path.join(tmp, label)
            run_cli(["fluid_3d", *args, "--hud"], label, out, frames, ("g2p_migrate_emit",))
            a, b = (read_png_rgb(os.path.join(out, f"frame_{i:05d}.png"))
                    for i in (0, frames - 1))
            du8 = float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())
            glyphs = int((b[:60, :200] == 255).all(axis=-1).sum())
            if not du8 > 1.0 or glyphs == 0:
                raise AssertionError(f"{label}: first to last {du8:.3f} mean |du8|, "
                                     f"{glyphs} HUD glyph pixels")
            phase(label, f"first to last frame {du8:.3f} mean |du8| (bar > 1); {glyphs} "
                  "white HUD pixels in the top-left box")
        run_cli(["dam_break_2d", "--interact", "sphere=32,20,6", "--hud"], "cli-render-2d-interact",
                os.path.join(tmp, "2d"), 3, ("sim2d",))


def phase_sharded_render(dev, smi: str, state, cfgw, pool, view) -> None:
    """One 640x360 sharded frame of the settled pool window on SLABS slabs
    equal to make_full_frame_step's frame from the same state, then 3
    windows of 40 timed frames."""
    rc = recipe_360(pool.config, view)
    bg = background_for_view(rc, view, dev)
    subs = pool.config.substeps
    mesh = domain.SlabMesh.on(dev, SLABS)
    sframe = make_sharded_frame_step(cfgw, mesh, rc, subs)
    ss, img = sframe(domain.shard_bucket_state(state, cfgw, mesh), pool.fluid, (), view, bg)
    ref, want = make_full_frame_step(cfgw, rc, subs)(state, pool.fluid, (), view, bg)
    g = domain.gather_bucket_state(ss)
    if not all(torch.equal(getattr(g, f), getattr(ref, f)) for f in ("pos", "vel", "C", "ids")):
        raise AssertionError("sharded render: the state differs from the single-device frame's")
    if not torch.equal(img, want):
        raise AssertionError(f"sharded 640x360 frame differs from the single-device frame in "
                             f"{int((img != want).any(dim=-1).sum())} pixels")
    reset_launches()
    ss, img, times = frame_windows(sframe, ss, pool.fluid, view, bg, 40, 3)
    launches = kernel_launches()
    if min(launches[k] for k in ("p2g1_shard", "g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"sharded render did not launch every kernel: {launches}")
    if int(ss.ceiling) != 0 or int(ss.lost) != int(state.lost):
        raise AssertionError("sharded render: particles lost or a ceiling hit")
    share = fluid_share(img, frame_to_u8(bg[0]), rc.crop)
    phase("render360-sharded", f"{SLABS} slabs: the first frame equals the single-device frame "
          f"bit for bit (state too); windows {[round(t, 4) for t in times]} s per 40 frames -> "
          f"{min(times) / 40 * 1e3:.3f} ms/frame best, {sorted(times)[1] / 40 * 1e3:.3f} median; "
          f"fluid on {share:.3f} of the crop; launches {launches} [{smi}]")


def _route_case(cfg, b, fluid, label, kernels, step, want_fn, count: int = 3) -> str:
    """`step(b, fluid)` (3 substeps through mode="cuda") with the counts set
    to 0 before and read after: bit-equal to `want_fn(b, fluid)`, each
    kernel of `kernels` launched `count` times and no other. Returns the
    run's lost and deferred counts and its launches."""
    torch.cuda.synchronize()
    reset_launches()
    got = step(b, fluid)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_launches().items() if v}
    want = want_fn(b, fluid)
    assert_bit_equal(got, want, f"[route] {label} through mode='cuda'")
    if launched != {k: count for k in kernels}:
        raise AssertionError(f"[route] {label}: launched {launched}, want {count} each of "
                             f"{kernels or 'none'}")
    return f"lost {int(got.lost)}, deferred {int(got.deferred)}, launches {launched or 'none'}"


def phase_route(dev, smi: str) -> None:
    """[route]: make_step(mode="cuda") against mode="bucketed", 3 substeps
    bit for bit. A fixed-point 2D config (dam_break_2d, K=8), which the JAX
    package runs on its XLA engine, takes the plain engine and launches no
    kernel. K > 32 takes the kernels' 64-bit slot masks and launches them:
    fluid_3d at full size with K=40, a dense fluid_3d (16^3, spacing 0.3:
    up to 64 particles a cell) with K=64, dam_break_2d with K=40. K > 64
    takes the kernels' 64-slot chunks: the dense scenes of utils/wide_k.py
    (16^3 fluid_3d, fullest cell above 64) at K = 72, 100, 128 and 200 and
    the dense 32^2 dam_break_2d at K=72; at K=72 also the per-pass kernels
    A, B, D and E under MPM_PALLAS_OLD=1 (against the per-pass substep of
    their plain versions) and the shard stages and F's shard mode on 4
    slabs (against the unsharded kernels). Clamps into the edge planes
    raise NotImplementedError; a windowed config outside the envelope
    raises ValueError. Each line gives the run's lost and deferred
    counts."""
    out = []
    d2 = dam_break_2d(device=dev)
    dense = fluid_3d(grid_res=16, box=8.0, spacing=0.3, device=dev)
    pf, pair = ("p2g_update", "g2p_migrate"), ("sim2d", "migrate2d")
    cases = [(d2.state, d2.config.replace(fixed_point=True, bin_capacity=8), d2.fluid,
              "dam_break_2d fixed", ()),
             (None, fluid_3d(device=dev), None, "fluid_3d K=40", pf),
             (dense.state, dense.config.replace(bin_capacity=64), dense.fluid,
              "dense fluid_3d K=64", pf),
             (d2.state, d2.config.replace(bin_capacity=40), d2.fluid, "dam_break_2d K=40", pair)]
    for st, cfg, fluid, label, kernels in cases:
        if st is None:  # fluid_3d at full size
            st, cfg, fluid = cfg.state, cfg.config.replace(bin_capacity=40), cfg.fluid
        b = bucketed.from_simstate(st, cfg)
        ran = _route_case(cfg, b, fluid, label, kernels,
                          make_step(cfg, mode="cuda", substeps=3),
                          make_step(cfg, mode="bucketed", substeps=3))
        out.append(f"{label} ({cuda_step.route(cfg)}, fullest cell "
                   f"{int((b.mass > 0).sum(0).max())}): 3 substeps bit-equal, {ran}")
    for dim, k in ((3, 72), (3, 100), (3, 128), (3, 200), (2, 72)):
        cfg, fluid, b = wide_k.dense_scene(dim, k, dev, grid=16 if dim == 3 else 32, warm=0)
        fill = int((b.mass > 0).sum(0).max())
        if fill <= 64:
            raise AssertionError(f"[route] dense K={k}: fullest cell {fill}, want > 64")
        kernels = pf if dim == 3 else pair
        ran = _route_case(cfg, b, fluid, f"dense {dim}D K={k}", kernels,
                          make_step(cfg, mode="cuda", substeps=3),
                          make_step(cfg, mode="bucketed", substeps=3))
        out.append(f"dense {dim}D K={k} (fullest cell {fill}): 3 substeps bit-equal, {ran}")
    cfg, fluid, b = wide_k.dense_scene(3, 72, dev, grid=16, warm=0)

    def plain_per_pass(s, fl):
        for _ in range(3):
            s = kpl.substep_plain(s, cfg, fl)
        return s

    ran = _route_case(cfg, b, fluid, "dense K=72 per pass",
                      ("p2g1_planes", "p2g2_planes", "g2p_planes", "migrate_planes"),
                      per_pass_step(cfg, 3), plain_per_pass)
    out.append(f"dense K=72 under MPM_PALLAS_OLD=1: bit-equal to the plain per-pass substep, "
               f"{ran}")
    mesh = domain.SlabMesh.on(dev, SLABS)
    sharded = domain.make_sharded_bucket_step(cfg, mesh, substeps=3)
    ran = _route_case(
        cfg, b, fluid, f"dense K=72 on {SLABS} slabs",
        ("p2g1_shard", "p2g2u_shard", "g2p_migrate_shard", "g2p_migrate"),  # F counts both
        lambda s, fl: domain.gather_bucket_state(
            sharded(domain.shard_bucket_state(s, cfg, mesh), fl)),
        make_step(cfg, mode="cuda", substeps=3), count=3 * SLABS)
    out.append(f"dense K=72 on {SLABS} slabs: bit-equal to the unsharded kernels, {ran}")
    for kw in (dict(clamp_lo=0.5), dict(clamp_hi_offset=1.0)):
        cfg = dense.config.replace(**kw)
        try:
            make_step(cfg, mode="cuda", substeps=1)(bucketed.from_simstate(dense.state, cfg),
                                                     dense.fluid)
        except NotImplementedError:
            out.append(f"{kw} raises NotImplementedError")
        else:
            raise AssertionError(f"[route] {kw} did not raise under mode='cuda'")
    wcfg = d2.config.replace(fixed_point=True,
                             domain_res=(d2.config.grid_res[0], 2 * d2.config.grid_res[1]))
    try:
        make_step(wcfg, mode="cuda", substeps=1)(bucketed.from_simstate(d2.state, wcfg),
                                                  d2.fluid)
    except ValueError as e:
        out.append(f"windowed fixed-point 2D raises ValueError ({str(e)[:48]}...)")
    else:
        raise AssertionError("[route] a windowed config outside the envelope did not raise")
    phase("route", "; ".join(out) + f" [{smi}]")


def spheres(lo, hi, n: int, seed: int) -> tuple:
    """n seeded spheres with centres in the box [lo, hi) (one bound a
    dimension), both kinds: the sphere's constant push (strength 0.1-0.5)
    and the mouse's radius / |d| falloff (0.02-0.1); the sixth inactive."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = rng.uniform(lo, hi).astype(np.float32).tolist()
        make, s_lo, s_hi = ((Interaction.sphere, 0.1, 0.5) if i % 2
                            else (Interaction.mouse, 0.02, 0.1))
        out.append(make(c, radius=float(rng.uniform(3.0, 6.0)),
                        strength=float(rng.uniform(s_lo, s_hi)), active=0.0 if i == 5 else 1.0))
    return tuple(out)


def phase_inter_many(dev, smi: str, state, cfgw, win, pool) -> tuple[float, float]:
    """[inter-many]: kernel F on the settled pool window and sim2d on
    bench2d, each with 12 spheres read from a device array, bit-equal to
    plain; 100 pool substeps with the 12 spheres, lost 0; `run` with nine
    --interact flags. Returns F's and sim2d's max abs error."""
    inter3 = spheres([8.0, 4.0, 8.0], [56.0, 14.0, 56.0], 12, 5)
    grid = kp.p2g_update_plain(state, cfgw, pool.fluid)
    got = kf.g2p_migrate(state, grid, cfgw, pool.fluid, inter3)
    want = kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid, inter3)
    torch.cuda.synchronize()
    assert_bit_equal(got, want, "kernel F with 12 spheres")
    bare = kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid)
    pushed = int((bare.vel != want.vel).any(dim=0).sum())
    err_f = max_err(got.vel, want.vel)
    del grid, got, want, bare
    b2 = benchmark_scene_2d(device=dev)
    s2 = bucketed.from_simstate(b2.state, b2.config)
    for _ in range(20):
        s2 = bucketed.substep(s2, b2.config, b2.fluid)
    inter2 = spheres([40.0, 40.0], [216.0, 216.0], 12, 6)
    got2 = k2d.sim2d(s2, b2.config, b2.fluid, inter2)
    want2 = k2d.sim2d_plain(s2, b2.config, b2.fluid, inter2)
    torch.cuda.synchronize()
    assert_bit_equal(got2, want2, "sim2d with 12 spheres")
    pushed2 = int((k2d.sim2d_plain(s2, b2.config, b2.fluid).vel != want2.vel).any(dim=0).sum())
    err_2d = max_err(got2.vel, want2.vel)
    lost0, hits0 = int(state.lost), win.interference
    reset_launches()
    s = state
    for _ in range(10):
        s = win.step(s, pool.fluid, inter3)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if int(s.lost) != lost0 or not state_is_finite(s):
        raise AssertionError(f"[inter-many] 100 substeps: lost {int(s.lost) - lost0} or "
                             "non-finite")
    if win.interference != hits0:
        # the window's certificate: a windowed run equals the full grid's
        raise AssertionError(f"[inter-many] window interference "
                             f"{win.interference - hits0} in 100 substeps")
    if min(launches["p2g_update"], launches["g2p_migrate"]) <= 0:
        raise AssertionError(f"[inter-many] the pool substeps did not launch P and F: {launches}")
    cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", "fluid_3d", "--frames", "3",
           "--window", "auto"]
    for i in range(9):
        cmd += ["--interact", f"sphere={8 + 6 * i},12,32,5,0.5"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if (res.returncode != 0 or "interactions=9" not in res.stdout
            or not re.search(r"^lost: 0 ", res.stdout, re.M)):
        raise AssertionError(f"run with nine --interact failed (rc {res.returncode}):\n"
                             f"{res.stdout}\n{res.stderr}")
    phase("inter-many", f"kernel F, settled pool window {cfgw.grid_res} K=8 bf16, 12 spheres: "
          f"bit-equal to plain, {pushed} slots pushed; sim2d, bench2d {b2.config.grid_res} K=4, "
          f"12 spheres: bit-equal, {pushed2} slots pushed; 100 pool substeps with the 12: lost 0, "
          f"window interference {win.interference - hits0} wy={win.wy}, "
          f"P={launches['p2g_update']} F={launches['g2p_migrate']}; run "
          f"fluid_3d with nine --interact: rc 0 | "
          + " | ".join(res.stdout.strip().splitlines()[-3:-1]) + f" [{smi}]")
    return err_f, err_2d


def phase_bf16_2d(dev, smi: str, time_pair) -> tuple[float, dict]:
    """[bf16-2d]: the 2D benchmark with bf16 vel/C (100,000 particles,
    256^2, K=4): sim2d and migrate2d bit-equal to plain on three perturbed
    states; bench2d's protocol (warm 100 substeps, 3 windows of 1,000,
    lost 0); both kernels timed. Returns the largest error and the launch
    counts of the main path."""
    b2 = benchmark_scene_2d(device=dev)
    cfg = b2.config.replace(storage_dtype="bfloat16")
    n2 = b2.state.num_particles
    s = bucketed.from_simstate(b2.state, cfg)
    if s.vel.dtype != torch.bfloat16:
        raise AssertionError("[bf16-2d] the state does not store bf16 vel/C")
    for _ in range(20):
        s = bucketed.substep(s, cfg, b2.fluid)
    err = 0.0
    deferred = []
    for seed in (1, 2, 3):
        st = perturbed(s, cfg, seed)
        got = k2d.sim2d(st, cfg, b2.fluid)
        want = k2d.sim2d_plain(st, cfg, b2.fluid)
        assert_bit_equal(got, want, f"sim2d bf16, perturbed state {seed}")
        gm = k2d.migrate2d(want, cfg)
        wm = k2d.migrate2d_plain(want, cfg)
        torch.cuda.synchronize()
        assert_bit_equal(gm, wm, f"migrate2d bf16, perturbed state {seed}")
        err = max(err, max_err(got.vel, want.vel), max_err(gm.vel, wm.vel))
        deferred.append(int(wm.deferred))
    step = make_step(cfg, mode="cuda", substeps=5)
    for _ in range(20):
        s = step(s, b2.fluid)
    torch.cuda.synchronize()
    reset_launches()
    s, t2 = fenced_windows(step, s, b2.fluid, WINDOW_CALLS)
    launches = kernel_launches()
    if int(s.lost) != 0 or not bool(torch.isfinite(s.pos).all()):
        raise AssertionError(f"[bf16-2d] lost {int(s.lost)} or non-finite positions")
    if min(launches["sim2d"], launches["migrate2d"]) <= 0 or launches["p2g_update"]:
        raise AssertionError(f"[bf16-2d] did not run on the 2D kernels alone: {launches}")
    pps = sorted(1000 * n2 / t for t in t2)
    phase("bf16-2d", f"{n2} particles, grid {cfg.grid_res}, K={cfg.bin_capacity}, bf16 vel/C: "
          f"sim2d and migrate2d bit-equal to plain on 3 perturbed states (deferred {deferred}); "
          f"windows {[round(t, 4) for t in t2]} s per 1000 substeps -> best "
          f"{pps[-1] / 1e6:.1f}M median {pps[1] / 1e6:.1f}M particle-steps/s; lost=0 "
          f"deferred={int(s.deferred)} launches={launches} [{smi}]")
    sm = k2d.sim2d(s, cfg, b2.fluid)
    time_pair("sim2d_bf16", lambda: k2d.sim2d(s, cfg, b2.fluid),
              lambda: k2d.sim2d_plain(s, cfg, b2.fluid), f"bench2d {cfg.grid_res} K=4 bf16",
              roofline.sim2d_work(s, cfg), device=True)
    time_pair("migrate2d_bf16", lambda: k2d.migrate2d(sm, cfg),
              lambda: k2d.migrate2d_plain(sm, cfg), f"bench2d {cfg.grid_res} K=4 bf16",
              roofline.migrate_work(sm, cfg), device=True)
    # the float32 pair's device time on the same particles, in this call
    cf = b2.config
    s32 = s.replace(vel=s.vel.float(), C=s.C.float())
    sm32 = k2d.sim2d(s32, cf, b2.fluid)
    phase("bf16-2d", f"device ms a call, f32 storage beside: sim2d "
          f"{device_ms(lambda: k2d.sim2d(s32, cf, b2.fluid)):.4f}, migrate2d "
          f"{device_ms(lambda: k2d.migrate2d(sm32, cf)):.4f} [{smi}]")
    return err, {"sim2d_bf16": launches["sim2d"], "migrate2d_bf16": launches["migrate2d"]}


def ulp_close(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """The largest |got - want| beyond max(atol, one float32 ulp of want);
    0 when every value is within it."""
    ulp = torch.abs(want) * 2.0 ** -23
    excess = (got - want).abs() - torch.clamp_min(ulp, atol)
    return float(torch.clamp_min(excess, 0).max())


def phase_oracle(dev, smi: str) -> None:
    """[oracle]: the golden 2D replay through the oracle on the card (frames
    1, 5, 10 within 2e-3 of the fixture); one oracle substep of fluid_3d at
    full size (157,464 particles, 64^3) against the binned engine: ids
    equal, vel/C within 1e-5, pos within 1e-6 or one float32 ulp of the
    value (the oracle adds each cell's run in float32, the binned engine in
    float64: their sums round apart by an ulp, which moves a position's last
    bit once in a few hundred)."""
    d2 = dam_break_2d(device=dev)
    data = np.load(GOLDEN_2D)
    step = make_step(d2.config, mode="reference")
    st, errs = d2.state, []
    t0 = time.perf_counter()
    for frame in range(1, 11):
        st = step(st, d2.fluid)
        if frame in (1, 5, 10):
            errs.append(float(np.abs(st.by_id().pos.cpu().numpy() - data[f"pos_f{frame}"]).max()))
    gold_s = time.perf_counter() - t0
    if not max(errs) <= 2e-3:
        raise AssertionError(f"[oracle] golden replay on the card: {errs}")
    sc = fluid_3d(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = make_step(sc.config, mode="reference", substeps=1)(sc.state, sc.fluid).by_id()
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    b = make_step(sc.config, mode="binned", substeps=1)(sc.state, sc.fluid).by_id()
    if not torch.equal(a.ids, b.ids):
        raise AssertionError("[oracle] fluid_3d: ids differ between oracle and binned")
    dpos = float((a.pos - b.pos).abs().max())
    npos = int((a.pos != b.pos).sum())
    beyond = ulp_close(b.pos, a.pos, 1e-6)
    dvc = max(max_err(a.vel, b.vel), max_err(a.C, b.C))
    if beyond > 0 or not dvc <= 1e-5:
        raise AssertionError(f"[oracle] fluid_3d oracle vs binned: pos {dpos} ({beyond} beyond "
                             f"one ulp), vel/C {dvc}")
    phase("oracle", f"golden 2D replay through the oracle on the card: max |pos - fixture| at "
          f"frames 1, 5, 10 = {errs} (bar 2e-3), {gold_s:.2f} s for 50 substeps; fluid_3d "
          f"{sc.state.num_particles} particles {sc.config.grid_res}, one substep, oracle "
          f"{ref_ms:.1f} ms (first call) against binned: ids equal, max |dpos| {dpos:.3g} at "
          f"{npos} of {a.pos.numel()} values, none beyond max(1e-6, 1 ulp); max |dvel|, |dC| "
          f"{dvc:.3g} (bar 1e-5) [{smi}]")


def phase_binned(dev, smi: str) -> None:
    """[binned]: fluid_3d under make_step(mode="binned"): 100 substeps with
    mass conserved and ids a permutation; 3 windows of 100 substeps beside
    mode="cuda" on the same scene; fluid_3d_fixed_point binned bit-equal
    across two runs."""
    sc = fluid_3d(device=dev)
    n = sc.state.num_particles
    m0 = float(sc.state.mass.double().sum())
    step = make_step(sc.config, mode="binned", substeps=10)
    st = sc.state
    for _ in range(10):
        st = step(st, sc.fluid)
    torch.cuda.synchronize()
    if (float(st.mass.double().sum()) != m0 or not bool(torch.isfinite(st.pos).all())
            or not torch.equal(torch.sort(st.ids).values,
                               torch.arange(n, dtype=torch.int32, device=dev))):
        raise AssertionError("[binned] 100 substeps: mass changed, non-finite or ids lost")
    st, tb_ = fenced_windows(step, st, sc.fluid, 10)
    cstep = make_step(sc.config, mode="cuda", substeps=10)
    cs = cstep(bucketed.from_simstate(sc.state, sc.config), sc.fluid)
    cs, tc = fenced_windows(cstep, cs, sc.fluid, 10)
    if int(cs.lost) != 0:
        raise AssertionError("[binned] the mode='cuda' run beside it lost particles")
    pb = sorted(100 * n / t for t in tb_)
    pc = sorted(100 * n / t for t in tc)
    s4 = fluid_3d_fixed_point(device=dev)
    fstep = make_step(s4.config, mode="binned", substeps=5)
    o1, o2 = fstep(s4.state, s4.fluid), fstep(s4.state, s4.fluid)
    for f in ("pos", "vel", "C", "ids"):
        if not torch.equal(getattr(o1, f), getattr(o2, f)):
            raise AssertionError(f"[binned] fixed point: two runs differ in {f}")
    phase("binned", f"fluid_3d {n} particles {sc.config.grid_res}: 100 substeps, mass conserved "
          f"exactly, ids a permutation; windows {[round(t, 4) for t in tb_]} s per 100 "
          f"substeps -> best {pb[-1] / 1e6:.2f}M median {pb[1] / 1e6:.2f}M particle-steps/s; "
          f"mode='cuda' beside it {[round(t, 4) for t in tc]} s -> best {pc[-1] / 1e6:.1f}M "
          f"median {pc[1] / 1e6:.1f}M; fluid_3d_fixed_point binned, 5 substeps: two runs "
          f"bit-equal [{smi}]")


def phase_sorted_shard(dev, smi: str) -> None:
    """[sorted-shard]: the sort-based sharded step on 4 slabs of the card
    against the binned engine on fluid_3d at full size (2 calls of 2
    substeps): ids equal, pos within 2e-3; the fixed-point scene bit-exact;
    demo_sharded_step(4)."""
    mesh = domain.SlabMesh.on(dev, SLABS)
    sc = fluid_3d(device=dev)
    sc = sc._replace(config=sc.config.replace(substeps=2))
    n = sc.state.num_particles
    out = []
    for scene, calls, label in ((sc, 2, "fluid_3d"), (None, 2, "fluid_3d_fixed_point")):
        if scene is None:
            s4 = fluid_3d_fixed_point(device=dev)
            scene = s4._replace(config=s4.config.replace(substeps=2))
        m = scene.state.num_particles
        sconf = domain.ShardConfig(n_shards=SLABS, local_capacity=m + 2 * 8192 + 64,
                                   migration_capacity=8192)
        state = domain.shard_scene(scene, sconf, mesh)
        step = domain.make_sharded_step(scene.config, sconf, mesh, substeps=2)
        ref = make_step(scene.config, mode="binned", substeps=2)
        s_ref = scene.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            state = step(state, scene.fluid)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        for _ in range(calls):
            s_ref = ref(s_ref, scene.fluid)
        live, want = domain.gather_live(state), s_ref.by_id()
        if live.num_particles != m or not torch.equal(live.ids, want.ids):
            raise AssertionError(f"[sorted-shard] {label}: {live.num_particles} live of {m}, "
                                 "or ids differ")
        err = float((live.pos - want.pos).abs().max())
        if scene is not sc:
            if not (torch.equal(live.pos, want.pos) and torch.equal(live.vel, want.vel)):
                raise AssertionError(f"[sorted-shard] {label}: not bit-exact ({err})")
        elif not err <= 2e-3:
            raise AssertionError(f"[sorted-shard] {label}: max |dpos| {err}")
        out.append(f"{label} ({m}) {2 * calls} substeps in {shard_s:.3f} s: ids equal, "
                   f"max |dpos| {err:.3g}" + (" (bit-exact)" if scene is not sc else ""))
    domain.demo_sharded_step(SLABS, dev)
    phase("sorted-shard", f"{SLABS} slabs of the card against binned: " + "; ".join(out)
          + f"; demo_sharded_step({SLABS}) ok [{smi}]")
    del n


def phase_cli_modes(dev, smi: str) -> None:
    """[cli-modes]: `run dam_break_2d --mode reference`, `run fluid_3d
    --mode binned --frames 3`, `render fluid_3d --render-mode legacy_quad
    --frames 3` (the bucket path, kernels P and F) and `render fluid_3d
    --mode binned --sphere-render-ratio 0.5 --frames 3`: rc 0, no particle
    lost, the frames unlike the background; ms a frame."""
    from mpm_tpu_torch.render import default_view as dview

    def run(args, label):
        res = subprocess.run([sys.executable, "-m", "mpm_tpu_torch", *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        ok = re.search(r"^(lost: 0 |particles: \d+ finite: True)", res.stdout, re.M)
        if res.returncode != 0 or not ok:
            raise AssertionError(f"{label} failed (rc {res.returncode}):\n{res.stdout}\n"
                                 f"{res.stderr}")
        return res.stdout

    out = []
    o = run(["run", "dam_break_2d", "--mode", "reference", "--frames", "10"], "run reference")
    out.append("run dam_break_2d --mode reference: "
               + re.search(r"^frames=.*$", o, re.M).group(0).split(" -> ")[0])
    o = run(["run", "fluid_3d", "--mode", "binned", "--frames", "3"], "run binned")
    out.append("run fluid_3d --mode binned: "
               + re.search(r"^frames=.*$", o, re.M).group(0).split(" -> ")[0])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_linear_") as tmp:
        for label, args in (("legacy_quad", ["--render-mode", "legacy_quad"]),
                            ("binned ratio 0.5", ["--mode", "binned", "--sphere-render-ratio",
                                                  "0.5"])):
            d = os.path.join(tmp, label.split()[0])
            o = run(["render", "fluid_3d", "--frames", "3", "--width", "640", "--height", "360",
                     "--out", d, *args], f"render {label}")
            rc = RenderConfig(camera=Camera(width=640, height=360))
            bg = frame_to_u8(background_for_view(rc, dview((64, 64, 64)), dev)[0]).cpu().numpy()
            diffs = []
            for f in sorted(os.listdir(d)):
                img = read_png_rgb(os.path.join(d, f)).astype(np.int32)
                diffs.append(int((np.abs(img - bg).max(axis=-1) > 20).sum()))
            if len(diffs) != 3 or min(diffs) == 0:
                raise AssertionError(f"render {label}: frames like the background {diffs}")
            ms = re.search(r"avg ([0-9.]+) ms/frame", o).group(1)
            out.append(f"render fluid_3d {label}: {ms} ms a frame, {diffs} pixels off the "
                       "background")
    phase("cli-modes", "; ".join(out) + f" [{smi}]")


WIDE_ROWS = ((3, 72), (3, 128), (2, wide_k.WIDE_2D_K))
FIT_KS = (64, 72, 128)


def phase_wide_k(smi: str, timing: dict, bounds: dict) -> tuple[dict, dict]:
    """[wide-k] (utils/wide_k.py): on the dense 32^3 fluid_3d at K = 72 and
    128 and the dense 128^2 dam_break_2d at K = 72 (64-slot chunks, cells of
    more than 64), 2 substeps through make_step(mode="cuda") with the launch
    counts set to 0 before and read after (each kernel launched twice, the
    state bit-equal to plain substeps); then on that state each kernel
    bit-equal to its plain version and timed beside it (CUDA events, plain,
    kernel, kernel, plain). The same on the fit 32^3 fluid_3d (at most 64 a
    cell) at K = 64, 72 and 128, the same particles at each K; ptxas's
    registers and spills of the chunked instantiations. Adds the dense rows
    `<kernel>_k<K>` to `timing` and `bounds`; returns their errors and
    launches."""
    dev = torch.device("cuda", 0)
    errs, launches = {}, {}

    def check(r, name):
        if r["max_abs_err"] != 0 or r["launches"] != 2:
            raise AssertionError(f"[wide-k] {name}: max abs err {r['max_abs_err']}, "
                                 f"{r['launches']} launches on the main path (want 0, 2)")
        phase("wide-k", f"{name} at {r['shape']}: main path 2 substeps, {r['launches']} "
              f"launches, bit-equal to plain; kernel {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms, "
              f"plain {r['plain_ms'][0]:.4f} / {r['plain_ms'][1]:.4f} ms; bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} B, {r['ops']} ops); "
              f"bit-equal [{smi}]")

    for dim, k in WIDE_ROWS:
        for r in (wide_k.rows_3d if dim == 3 else wide_k.rows_2d)(k, dev):
            name = f"{r['name']}_k{k}"
            check(r, name)
            errs[name], launches[name] = r["max_abs_err"], r["launches"]
            timing[name] = (sum(r["ms"]) / 2, sum(r["plain_ms"]) / 2)
            bounds[name] = (r["bound_ms"], r["bound_by"])
    for k in FIT_KS:
        for r in wide_k.rows_3d(k, dev, fit=True):
            check(r, f"{r['name']} fit K={k}")
    for line in wide_k.wide_resources(build.build_logs):
        phase("wide-k", line)
    return errs, launches


def png_filters(path: str) -> set:
    """The row filter bytes of an 8-bit RGB PNG file."""
    data = open(path, "rb").read()
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w = struct.unpack(">I", body[:4])[0]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    return set(raw[::w * 3 + 1])


def phase_native(smi: str, frame_u8: np.ndarray) -> None:
    """[native]: the frame-I/O library (mpm_tpu_torch/native) built on this
    host and loaded; ms to encode one 1920x1080 frame of the 1080p loop
    natively (zlib level 1, "up" rows) and with the standard library (level
    6), each decoding to the frame; then `render fluid_3d` at 1920x1080 for
    20 frames: its ms a frame, its PNGs read back, each with the native
    encoder's rows (filter 0, then 2)."""
    from mpm_tpu_torch import native
    from mpm_tpu_torch.render.image import encode_png_stdlib

    if not native.available():
        raise AssertionError(f"[native] the frame-I/O library did not build or load:\n"
                             f"{native.build_error}")
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        for label, enc in (("native", lambda: native.encode_png(frame_u8, compress_level=1)),
                           ("stdlib", lambda: encode_png_stdlib(frame_u8, 6))):
            data = enc()
            t0 = time.perf_counter()
            for _ in range(5):
                enc()
            times[label] = ((time.perf_counter() - t0) / 5 * 1e3, len(data))
            path = os.path.join(tmp, f"{label}.png")
            with open(path, "wb") as f:
                f.write(data)
            if not np.array_equal(read_png_rgb(path), frame_u8):
                raise AssertionError(f"[native] the {label} PNG does not decode to its frame")
        out = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        stdout = run_cli(["fluid_3d", "--width", "1920", "--height", "1080"], "cli-render-1080",
                         out, 20, ("g2p_migrate_emit", "blur_depth"))
        wall = time.perf_counter() - t0
        pngs = sorted(os.path.join(out, f) for f in os.listdir(out) if f.endswith(".png"))
        shapes = {read_png_rgb(f).shape for f in pngs}
        filters = set().union(*(png_filters(f) for f in pngs))
        if shapes != {(1080, 1920, 3)} or filters != {0, 2}:
            raise AssertionError(f"[native] render's PNGs: shapes {shapes}, row filters "
                                 f"{filters} (want the native encoder's 0 then 2)")
    avg = re.search(r"avg ([\d.]+) ms/frame", stdout)
    phase("native", f"library {native.lib_path().name} loaded; one 1920x1080 frame: native "
          f"{times['native'][0]:.2f} ms ({times['native'][1]} B), stdlib level 6 "
          f"{times['stdlib'][0]:.2f} ms ({times['stdlib'][1]} B), both decode to the frame; "
          f"render fluid_3d 1920x1080 x 20: {avg.group(1) if avg else '?'} ms/frame after the "
          f"first (the CLI's line, PNG writes included), {wall:.1f} s in all, 20 PNGs read "
          f"back, rows filtered 0 then 2 (the native encoder) [{smi}]")


def phase_ladder(smi: str, t_start: float) -> None:
    """[ladder]: utils/ladder.py's rows 3a and 4a (250k on a true 64^3, 4M on
    a true 128^3, through the air window), then 3 and 4 (the same without
    the window) unless the run has passed 400 s: lost 0, finite positions."""
    from mpm_tpu_torch.utils import ladder

    dev = torch.device("cuda", 0)
    for row in ("3a", "4a", "3", "4"):
        if row in ("3", "4") and time.perf_counter() - t_start > 400:
            phase("ladder", f"row {row} left out: the run has taken "
                  f"{time.perf_counter() - t_start:.0f} s (python -m mpm_tpu_torch.utils.ladder "
                  f"{row} runs it)")
            continue
        res = ladder.run_row(row, dev, log=lambda *_: None)
        if res["lost"] != 0 or not res["finite"]:
            raise AssertionError(f"[ladder] row {row}: {res}")
        keys = ("ms_per_substep", "particle_steps_per_s", "lost", "deferred", "wy", "resizes",
                "ceiling_hits", "ns_per_slot")
        phase("ladder", f"row {row}: {res['particles']} particles, grid {tuple(res['grid'])}, "
              f"K={res['K']}: " + " ".join(f"{k}={res[k]}" for k in keys if k in res)
              + f"; windows {[round(t, 4) for t in res['window_s']]} s [{smi}]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    t_start = time.perf_counter()
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
    build.build_all(KERNELS)
    phase("build", f"{time.perf_counter() - t0:.1f}s; nvcc per kernel: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in build.build_seconds.items()))

    # sharded demos on SLABS slabs of the card (parallel/domain.py:702-746,
    # parallel/render.py:190-233): each equals its unsharded run bit for bit
    domain.demo_sharded_bucket_step(SLABS, dev)
    demo_sharded_render(SLABS, dev)
    phase_route(dev, smi)
    phase("shard-demo", f"demo_sharded_bucket_step({SLABS}) (f32, windowed, bf16) and "
          f"demo_sharded_render({SLABS}) (whole and windowed): lost 0, equal to their "
          "unsharded runs bit for bit")

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
    # the shard kernels on 4 slabs of 16 planes: fluid_3d float and fixed
    errs_shard = check_shard_kernels(s3, cfg3, sc.fluid, rs3, f"fluid_3d {cfg3.grid_res} K=16 f32")
    cfgx = cfg3.replace(fixed_point=True)
    sx = bucketed.from_simstate(sc.state, cfgx)
    for _ in range(3):
        sx = bucketed.substep(sx, cfgx, sc.fluid)
    for k, v in check_shard_kernels(sx, cfgx, sc.fluid, rs3,
                                    f"fluid_3d {cfgx.grid_res} K=16 fixed").items():
        errs_shard[k] = max(errs_shard[k], v)
    del s3, sp, sx

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
    state, times = fenced_windows(win.step, state, pool.fluid, 10)  # 100 substeps each
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
    # in turns plain, kernel, kernel, plain, beside the roofline bound of
    # the same call's work (utils/roofline.py)
    cfgw = win.config
    grid = kp.p2g_update(state, cfgw, pool.fluid)
    runs = {"p2g_update": (lambda: kp.p2g_update(state, cfgw, pool.fluid),
                           lambda: kp.p2g_update_plain(state, cfgw, pool.fluid),
                           roofline.p2g_update_work(state, cfgw)),
            "g2p_migrate": (lambda: kf.g2p_migrate(state, grid, cfgw, pool.fluid),
                            lambda: kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid),
                            roofline.g2p_migrate_work(state, cfgw))}
    timing, bounds = {}, {}

    def time_pair(kname, kern, plain, shape, work, device=False):
        """CUDA events; with `device`, the kernel's device time a call too,
        with the host's time hidden (profile_render_kernels.device_ms)."""
        p1 = cuda_time_ms(plain, iters=5)
        k1 = cuda_time_ms(kern, iters=50)
        k2 = cuda_time_ms(kern, iters=50)
        p2 = cuda_time_ms(plain, iters=5)
        timing[kname] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[kname] = roofline.bound_ms(*work)
        dev_ms = f", device {device_ms(kern):.4f} ms" if device else ""
        phase("time", f"{kname} at {shape}: kernel {k1:.4f} / {k2:.4f} ms{dev_ms}, "
              f"plain {p1:.4f} / {p2:.4f} ms; bound {bounds[kname][0]:.5f} ms by "
              f"{bounds[kname][1]} ({work[0]} B, {work[1]} ops"
              f"{f', {work[2]} special-function ops' if len(work) > 2 else ''}) [{smi}]")

    for kname, (kern, plain, work) in runs.items():
        time_pair(kname, kern, plain, f"window {cfgw.grid_res} K={cfgw.bin_capacity}", work)

    # kernels X and F-with-emission on the settled pool window (bf16, K=8)
    view = default_view(pool.config.grid_res)  # the scene's camera, not the window's
    rs = kx.render_scals_for(view, cam360)
    err_x = max(err_x, check_x(state, view, cam360, f"settled pool window {cfgw.grid_res} "
                                                    "K=8 bf16"))
    err_fe = max(err_fe, check_f_emit(state, grid, cfgw, pool.fluid, rs,
                                      f"settled pool window {cfgw.grid_res} K=8 bf16"))
    for k, v in check_shard_kernels(state, cfgw, pool.fluid, rs,
                                    f"settled pool window {cfgw.grid_res} K=8 bf16").items():
        errs_shard[k] = max(errs_shard[k], v)
    def emit_plain():
        out = kf.g2p_migrate_plain(state, grid, cfgw, pool.fluid)
        return kx.cell_splats_plain(out.pos, out.vel, out.mass, rs)

    time_pair("g2p_migrate_emit",
              lambda: kf.g2p_migrate(state, grid, cfgw, pool.fluid, emit_splats=True,
                                     render_scals=rs),
              emit_plain, f"window {cfgw.grid_res} K=8",
              roofline.g2p_migrate_work(state, cfgw, emit=True), device=True)
    time_pair("extract_cells", lambda: kx.extract_cell_splats(state, view, cam360),
              lambda: kx.extract_cell_splats_plain(state, view, cam360),
              f"window {cfgw.grid_res} K=8",
              roofline.extract_cells_work(state, kx.extract_cell_splats(state, view, cam360),
                                          kx.CELL_BG), device=True)
    del grid, runs

    # 11. main path: the render loop at 640x360 on the frozen settled window
    # (bench.py's with-render line): 2 substeps a frame, the last with kernel
    # F's emission, cell quality, the domain crop, u8 frames to the host
    lost0 = int(state.lost)
    rc = recipe_360(pool.config, view)
    bg = background_for_view(rc, view, dev)
    subs = pool.config.substeps
    frame = make_full_frame_step(cfgw, rc, subs)
    state, _ = frame(state, pool.fluid, (), view, bg)  # warm
    reset_launches()
    state, img, rtimes = frame_windows(frame, state, pool.fluid, view, bg, 40, 3)
    launches360 = kernel_launches()
    ceiling = int(state.ceiling)
    if int(state.lost) != lost0 or ceiling != 0:
        raise AssertionError(f"640x360 render: lost {int(state.lost) - lost0}, "
                             f"ceiling {ceiling}")
    for k in ("p2g_update", "g2p_migrate", "g2p_migrate_emit", "blur_depth",
              "ssfr_shade", "splat_zbuffer", "splat_dilate"):
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
    reset_launches()
    state, img1080, htimes = frame_windows(frame1080, state, pool.fluid, view, bg1080, 10, 2)
    launches1080 = kernel_launches()
    uncovered = surface_band_uncovered(state, cfgw.grid_res, bands)
    if int(state.lost) != lost0 or int(state.ceiling) != 0 or uncovered != 0:
        raise AssertionError(f"1080p render: lost {int(state.lost) - lost0}, ceiling "
                             f"{int(state.ceiling)}, band certificate {uncovered}")
    if min(launches1080[k] for k in ("g2p_migrate_emit", "blur_depth")) <= 0:
        raise AssertionError(f"1080p render did not launch every kernel: {launches1080}")
    frame1080_u8 = img1080.cpu().numpy()
    share1080 = fluid_share(img1080, frame_to_u8(bg1080[0]), rc1080.crop)
    if share1080 < 0.1:
        raise AssertionError(f"1080p render: fluid on only {share1080:.3f} of the crop")
    hps = sorted(10 * subs * n / t for t in htimes)
    phase("render1080", f"bands {bands}, crop {rc1080.crop}, windows "
          f"{[round(t, 4) for t in htimes]} s per 10 frames -> "
          f"{min(htimes) / 10 * 1e3:.3f} ms/frame best; best {hps[-1] / 1e6:.1f}M "
          f"particle-steps/s with render; lost 0 ceiling 0 band certificate 0; fluid on "
          f"{share1080:.3f} of the crop; launches {launches1080} [{smi}]")

    # 10. kernel BL against its plain version, then timed beside it, on the
    # pool's splat buffers after the render loops: the crops the two loops
    # blur, and the full 640x360 and 1920x1080 frames with a near patch at
    # depth 1.5 (fsize 100)
    err_bl, fsize_max = 0.0, 0
    for key, (d, cam) in blur_buffers(state, view, rc.crop, rc1080.crop).items():
        label = f"pool splat buffer, {key}" if key.startswith("crop") else \
            f"pool splat buffer {cam.width}x{cam.height} + near patch"
        e, f = check_bl(d, cam, label)
        err_bl, fsize_max = max(err_bl, e), max(fsize_max, f)
        time_pair({"crop360": "blur_depth", "crop1080": "blur_depth_1080"}.get(
                      key, "blur_depth_" + key),
                  lambda: kb.blur_depth_kernel(d, cam, **BL_ARGS),
                  lambda: kb.blur_depth_plain(d, cam, **BL_ARGS), f"{key} {tuple(d.shape)}",
                  roofline.blur_work(*blur_fsizes(d, cam)), device=True)
    if fsize_max < 100:
        raise AssertionError(f"kernel BL never ran fsize 100 (largest {fsize_max})")

    # the splat kernels against the plain chain, then timed beside it, at
    # the benchmark cell's 1080p crop
    cells_sp, _, rc_sp = splat_inputs(dev)
    cam_sp, crop_sp, R_sp = rc_sp.camera, rc_sp.crop, rc_sp.max_radius_px
    r_sp = rc_sp.ssfr.particle_sphere_radius
    d_sp = check_splat(cells_sp, rc_sp)
    time_pair("splat_zbuffer", lambda: rsplat.zbuffer_cells(cells_sp, cam_sp, crop_sp),
              lambda: rsplat.zbuffer_cells_plain(cells_sp, cam_sp, crop_sp),
              f"{cells_sp.shape[1]} cell splats, crop {crop_sp}",
              roofline.zbuffer_work(cells_sp, crop_sp[2], crop_sp[3]), device=True)
    time_pair("splat_dilate", lambda: rsplat.buffers_from_zbuffer(d_sp, cam_sp, r_sp, R_sp),
              lambda: rsplat.buffers_from_zbuffer_plain(d_sp, cam_sp, r_sp, R_sp),
              f"crop {crop_sp} R {R_sp}, {int((d_sp < rsplat.BG_DEPTH).sum())} centres",
              roofline.dilate_work(d_sp, cam_sp, r_sp, R_sp), device=True)
    del cells_sp, d_sp

    # kernel SH against its plain version, then timed beside it, at the
    # benchmark cell's 1080p crop
    kw_sh = shade_buffers(dev)
    err_sh, live_sh = check_sh(kw_sh, f"flagship_3d 1920x1080, crop {kw_sh['crop']}")
    time_pair("ssfr_shade", lambda: ksh.shade_kernel(**kw_sh), lambda: ksh.shade_plain(**kw_sh),
              f"1920x1080 crop {kw_sh['crop']}", roofline.shade_work(live_sh, kw_sh["bg_color"]),
              device=True)
    del kw_sh, live_sh

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
    mode_launches = phase_render_modes(dev, smi, state, win.config, pool, view)
    state = phase_thickness_1080(dev, smi, state, win.config, pool, view)
    phase_particles_and_cubemap(dev, smi, state, win.config, pool, view)
    phase_sharded_render(dev, smi, state, win.config, pool, view)
    phase_sharded_modes(dev, smi, state, win.config, pool, view)
    # the run-time surface: F's interaction branch, the guard, the orbit
    # camera, each from the settled state (the window follows its height)
    cfgw = win.config
    err_f = max(err_f, phase_interactions(dev, smi, state, cfgw, win, pool))
    err_f_many, err_2d_many = phase_inter_many(dev, smi, state, cfgw, win, pool)
    err_f = max(err_f, err_f_many)
    phase_guard(dev, smi, state, win, pool)
    phase_moving_camera(dev, smi, state, cfgw, pool, view)
    del state

    # 7. main path: the 1M dam-break, no window
    dam = benchmark_dam_break(N_POOL, device=dev)
    dstep = make_step(dam.config, mode="cuda", substeps=10)
    ds = bucketed.from_simstate(dam.state, dam.config)
    for _ in range(6):  # substep 60: mid-collapse
        ds = dstep(ds, dam.fluid)
    ds, dtimes = fenced_windows(dstep, ds, dam.fluid, 10)
    if int(ds.lost) != 0 or not bool(torch.isfinite(ds.pos).all()):
        raise AssertionError(f"dam-break: lost={int(ds.lost)} or non-finite")
    dpps = sorted(100 * N_POOL / t for t in dtimes)
    phase("dam", f"{N_POOL} particles, grid {dam.config.grid_res}, windows "
          f"{[round(t, 4) for t in dtimes]} s per 100 substeps -> best "
          f"{dpps[-1] / 1e6:.1f}M median {dpps[1] / 1e6:.1f}M particle-steps/s; "
          f"lost=0 deferred={int(ds.deferred)} [{smi}]")
    del ds

    err_sim2d, err_mig2d, launches2d = phase_2d(dev, smi, time_pair)
    err_sim2d = max(err_sim2d, err_2d_many)
    err_bf16, launches_bf16 = phase_bf16_2d(dev, smi, time_pair)
    phase_oracle(dev, smi)
    phase_binned(dev, smi)
    phase_sorted_shard(dev, smi)
    errs_new, launches_new = phase_per_pass_fixed(dev, smi, time_pair)
    launches_shard, s5, cfg5, true_cfg5, fluid5 = run_config5(dev, smi)
    phase_shard_times(s5, cfg5, fluid5, time_pair)
    phase_config5_render(dev, smi, s5, cfg5, true_cfg5, fluid5)
    del s5
    phase_stress_tests()
    errs_wide, launches_wide = phase_wide_k(smi, timing, bounds)

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
    cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", "bench2d", "--frames", "5"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if (res.returncode != 0 or not re.search(r"^lost: 0 ", res.stdout, re.M)
            or not re.search(r"particle-steps/s on cuda$", res.stdout, re.M)):
        raise AssertionError(f"2D CLI failed (rc {res.returncode}):\n{res.stdout}\n{res.stderr}")
    phase("cli-2d", " | ".join(res.stdout.strip().splitlines()[-3:]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli2d_") as out:
        cmd = [sys.executable, "-m", "mpm_tpu_torch", "render", "dam_break_2d", "--frames", "3",
               "--out", out]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        sim_launch = re.search(r"sim2d=(\d+)", res.stdout)
        if (res.returncode != 0 or len(pngs) != 3 or not sim_launch
                or int(sim_launch.group(1)) <= 0):
            raise AssertionError(f"2D render CLI failed (rc {res.returncode}, {len(pngs)} "
                                 f"PNGs):\n{res.stdout}\n{res.stderr}")
    phase("cli-render-2d", " | ".join(res.stdout.strip().splitlines()[-3:]))
    for scene, env, ran in (("fluid_3d", {"MPM_PALLAS_OLD": "1"}, "p2g1_planes"),
                            ("fluid_3d_fixed_point", {}, "p2g_update")):
        cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", scene, "--frames", "5"]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, **env))
        launched = re.search(rf"{ran}=(\d+)", res.stdout)
        skipped = re.search(r"p2g_update=(\d+)" if env else r"p2g1_planes=(\d+)", res.stdout)
        if (res.returncode != 0 or not re.search(r"^lost: 0 ", res.stdout, re.M)
                or not re.search(r"particle-steps/s on cuda$", res.stdout, re.M)
                or not launched or int(launched.group(1)) <= 0
                or not skipped or int(skipped.group(1)) != 0):
            raise AssertionError(f"run {scene} {env} failed (rc {res.returncode}):\n"
                                 f"{res.stdout}\n{res.stderr}")
        phase("cli-" + scene, " ".join(f"{k}={v}" for k, v in env.items()) + " | "
              + " | ".join(res.stdout.strip().splitlines()[-3:]))
    cmd = [sys.executable, "-m", "mpm_tpu_torch", "run", "fluid_3d", "--frames", "5",
           "--shards", "1", "--window", "auto"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    shard_launch = re.search(r"p2g1_shard=(\d+)", res.stdout)
    if (res.returncode != 0 or not re.search(r"^lost: 0 ", res.stdout, re.M)
            or "mesh: 1 x-slab shard(s) over cuda devices" not in res.stdout
            or not shard_launch or int(shard_launch.group(1)) <= 0):
        raise AssertionError(f"run --shards 1 failed (rc {res.returncode}):\n{res.stdout}\n"
                             f"{res.stderr}")
    phase("cli-shards", " | ".join(res.stdout.strip().splitlines()[-4:]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_shards_") as out:
        cmd = [sys.executable, "-m", "mpm_tpu_torch", "render", "fluid_3d", "--frames", "3",
               "--shards", "1", "--out", out]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        emit = re.search(r"g2p_migrate_emit=(\d+)", res.stdout)
        shard_launch = re.search(r"g2p_migrate_shard=(\d+)", res.stdout)
        if (res.returncode != 0 or len(pngs) != 3 or not emit or int(emit.group(1)) <= 0
                or not shard_launch or int(shard_launch.group(1)) <= 0):
            raise AssertionError(f"render --shards 1 failed (rc {res.returncode}, {len(pngs)} "
                                 f"PNGs):\n{res.stdout}\n{res.stderr}")
    phase("cli-render-shards", " | ".join(res.stdout.strip().splitlines()[-4:]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_modes_") as tmp:
        faces = os.path.join(tmp, "faces")
        os.makedirs(faces)
        write_gradient_faces(faces)
        run_cli(["fluid_3d", "--render-mode", "velocity_spheres"], "cli-render-velocity",
                os.path.join(tmp, "v"), 3, ("g2p_migrate_emit",))
        run_cli(["fluid_3d", "--thickness-pass"], "cli-render-thickness",
                os.path.join(tmp, "t"), 3, ("g2p_migrate_emit", "blur_depth"))
        run_cli(["fluid_3d", "--sphere-render-ratio", "0.5"], "cli-render-ratio",
                os.path.join(tmp, "r"), 2, ("p2g_update", "blur_depth"))
        run_cli(["fluid_3d", "--cubemap", faces], "cli-render-cubemap",
                os.path.join(tmp, "c"), 2, ("g2p_migrate_emit", "blur_depth"))
    phase_cli_runtime()
    phase_cli_modes(dev, smi)
    phase_native(smi, frame1080_u8)
    phase_ladder(smi, t_start)

    # launches: each kernel's count from the main path that runs it (the
    # pool for P and F, the 640x360 render loops of every mode for the
    # emission, BL, SH and the splat kernels, the windowed render path for X)
    launches.update({k: launches360[k] + mode_launches[k]
                     for k in ("g2p_migrate_emit", "blur_depth", "ssfr_shade", "splat_zbuffer",
                               "splat_dilate")})
    launches["extract_cells"] = launches_win["extract_cells"]
    launches.update({k: launches2d[k] for k in ("sim2d", "migrate2d")})
    launches.update(launches_new)
    launches.update(launches_shard)
    launches.update(launches_bf16)
    src = {"p2g_update": ("mpm_tpu_torch/csrc/p2g_update.cu",
                          "mpm_tpu/ops/pallas/p2g_fused.py:168", err_p),
           "g2p_migrate": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                           "mpm_tpu/ops/pallas/fused.py:387", err_f),
           "g2p_migrate_emit": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                                "mpm_tpu/ops/pallas/fused.py:890", err_fe),
           "extract_cells": ("mpm_tpu_torch/csrc/extract_cells.cu",
                             "mpm_tpu/render/extract_kernel.py:34", err_x),
           "blur_depth": ("mpm_tpu_torch/csrc/blur_depth.cu",
                          "mpm_tpu/render/blur_kernel.py:61", err_bl),
           "ssfr_shade": ("mpm_tpu_torch/csrc/ssfr_shade.cu",
                          "none (plain jnp, mpm_tpu/render/ssfr.py:232)", err_sh),
           "splat_zbuffer": ("mpm_tpu_torch/csrc/splat_dilate.cu",
                             "none (plain jnp, mpm_tpu/render/splat.py:304)", 0.0),
           "splat_dilate": ("mpm_tpu_torch/csrc/splat_dilate.cu",
                            "none (plain jnp, mpm_tpu/render/splat.py:228)", 0.0),
           "sim2d": ("mpm_tpu_torch/csrc/substep2d.cu",
                     "mpm_tpu/ops/pallas/kernels2d.py:50", err_sim2d),
           "migrate2d": ("mpm_tpu_torch/csrc/substep2d.cu",
                         "mpm_tpu/ops/pallas/kernels2d.py:231", err_mig2d),
           "sim2d_bf16": ("mpm_tpu_torch/csrc/substep2d.cu",
                          "mpm_tpu/ops/pallas/kernels2d.py:50", err_bf16),
           "migrate2d_bf16": ("mpm_tpu_torch/csrc/substep2d.cu",
                              "mpm_tpu/ops/pallas/kernels2d.py:231", err_bf16),
           "p2g1_planes": ("mpm_tpu_torch/csrc/planes.cu",
                           "mpm_tpu/ops/pallas/bucket_kernels.py:108",
                           errs_new["p2g1_planes"]),
           "p2g2_planes": ("mpm_tpu_torch/csrc/planes.cu",
                           "mpm_tpu/ops/pallas/bucket_kernels.py:154",
                           errs_new["p2g2_planes"]),
           "g2p_planes": ("mpm_tpu_torch/csrc/planes.cu",
                          "mpm_tpu/ops/pallas/bucket_kernels.py:236", errs_new["g2p_planes"]),
           "migrate_planes": ("mpm_tpu_torch/csrc/planes.cu",
                              "mpm_tpu/ops/pallas/migrate_kernels.py:115",
                              errs_new["migrate_planes"]),
           "p2g_update_fixed": ("mpm_tpu_torch/csrc/p2g_update.cu",
                                "mpm_tpu/ops/pallas/p2g_fused.py:168",
                                errs_new["p2g_update_fixed"]),
           "g2p_migrate_fixed": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                                 "mpm_tpu/ops/pallas/fused.py:387",
                                 errs_new["g2p_migrate_fixed"]),
           "p2g1_shard": ("mpm_tpu_torch/csrc/p2g_shard.cu",
                          "mpm_tpu/ops/pallas/p2g_fused.py:543", errs_shard["p2g1_shard"]),
           "p2g2u_shard": ("mpm_tpu_torch/csrc/p2g_shard.cu",
                           "mpm_tpu/ops/pallas/p2g_fused.py:586", errs_shard["p2g2u_shard"]),
           "g2p_migrate_shard": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                                 "mpm_tpu/ops/pallas/fused.py:387",
                                 errs_shard["g2p_migrate_shard"])}
    # the slot-count rows: [wide-k]'s main path on the dense scenes (counts
    # set to 0 before, read after), then bit-equal and timed on its state
    base = {"p2g_update": src["p2g_update"], "g2p_migrate": src["g2p_migrate"],
            "sim2d": src["sim2d"], "migrate2d": src["migrate2d"]}
    for row, err in errs_wide.items():
        kern = row.rsplit("_k", 1)[0]
        src[row] = (base[kern][0], base[kern][1], err)
        launches[row] = launches_wide[row]
    # library_ms: no single PyTorch call computes any of these functions
    kernels = [{"name": k, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[k], "max_abs_err": e,
                "ms": timing[k][0], "plain_ms": timing[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None}
               for k, (s, r, e) in src.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
