#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds kernels P and F from mpm_tpu_torch/csrc, holds each against its plain
PyTorch version at full width, replays the 3D golden trajectory through the
kernels, drives the main path (the 1M benchmark pool under the air-window
engine, and the 1M dam-break), runs the CLI, and times each kernel beside its
plain version. Any failure raises, so the exit code is not 0. The line before
the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from mpm_tpu_torch.__main__ import nvidia_smi_power
from mpm_tpu_torch.models.scenes import benchmark_dam_break, benchmark_scene, fluid_3d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.cuda import build
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.utils.timing import cuda_time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_3D = os.path.join(ROOT, "tests", "golden", "fluid_3d_small_bucketed.npz")
N_BENCH = 1_000_000


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


def check_f(state, grid, config, fluid, label: str) -> float:
    """Kernel F vs plain from the same grid velocity: ids slot for slot,
    pos atol 1e-6, vel/C atol 1e-5 (f32) or rtol 0.01 atol 1e-4 (bf16),
    counters equal (the JAX package's bars, tests/test_fused.py)."""
    got = kf.g2p_migrate(state, grid, config, fluid)
    want = kf.g2p_migrate_plain(state, grid, config, fluid)
    torch.cuda.synchronize()
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

    # 2. build
    t0 = time.perf_counter()
    build.load("p2g_update")
    build.load("g2p_migrate")
    phase("build", f"{time.perf_counter() - t0:.1f}s; nvcc per kernel: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in build.build_seconds.items()))

    # 3-4. kernels vs plain: fluid_3d at full width (f32, K=16) after three
    # plain substeps, and the benchmark pool's window (bf16, K=8)
    sc = fluid_3d(device=dev)
    cfg3 = sc.config
    s3 = bucketed.from_simstate(sc.state, cfg3)
    for _ in range(3):
        s3 = bucketed.substep(s3, cfg3, sc.fluid)
    pool = benchmark_scene(N_BENCH, device=dev)
    win = YWindow(pool.config, mode="cuda", substeps=10, headroom=4)
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
    kp.launches = 0
    kf.launches = 0
    for _ in range(15):  # settle 150 substeps
        state = win.step(state, pool.fluid)
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
    for kname, (kern, plain) in runs.items():
        p1 = cuda_time_ms(plain, iters=5)
        k1 = cuda_time_ms(kern, iters=50)
        k2 = cuda_time_ms(kern, iters=50)
        p2 = cuda_time_ms(plain, iters=5)
        timing[kname] = ((k1 + k2) / 2, (p1 + p2) / 2)
        phase("time", f"{kname} at window {cfgw.grid_res} K={cfgw.bin_capacity}: "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms [{smi}]")
    del state, grid, runs

    # 7. main path: the 1M dam-break, no window
    dam = benchmark_dam_break(N_BENCH, device=dev)
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
    dpps = sorted(100 * N_BENCH / t for t in dtimes)
    phase("dam", f"{N_BENCH} particles, grid {dam.config.grid_res}, windows "
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

    src = {"p2g_update": ("mpm_tpu_torch/csrc/p2g_update.cu",
                          "mpm_tpu/ops/pallas/p2g_fused.py:168", err_p),
           "g2p_migrate": ("mpm_tpu_torch/csrc/g2p_migrate.cu",
                           "mpm_tpu/ops/pallas/fused.py:387", err_f)}
    kernels = [{"name": k, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[k], "max_abs_err": e,
                "ms": timing[k][0], "plain_ms": timing[k][1]}
               for k, (s, r, e) in src.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
