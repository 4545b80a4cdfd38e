"""Times the render kernels at the render path's shapes on a CUDA card,
each call split three ways: kernel BL on its four buffers (blur_buffers),
kernel X at the settled pool window, and kernel F with its splat emission
there.

    python -m mpm_tpu_torch.utils.profile_render_kernels

Per call of the wrapper it prints the CUDA event time (50 calls between two
events: the larger of the host's and the device's time a call), the device
time (50 calls queued behind a device sleep, between two events: device_ms)
and the host's enqueue time (50 calls on the host's clock, no synchronise
inside). The script uses only the wrappers' public functions,
so a copy of it times another checkout's package the same way. Needs a
card.
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..models.scenes import benchmark_scene
from ..ops.cuda import g2p_migrate as kf
from ..ops.cuda import p2g_update as kp
from ..render import Camera, default_view
from ..render import blur_kernel as kb
from ..render import extract_kernel as kx
from ..render.splat import splat_cells
from .render_bench import N_POOL, pool_window, recipe_360, recipe_1080, settle
from .timing import cuda_time_ms

# kernel BL's arguments on these buffers: radius and max_filter 100 (the
# reference's max_filter_size), blur_filter_size 7 (35 x the sphere radius
# 0.2), depth_threshold 10
BL_ARGS = dict(radius=100, max_filter=100, blur_filter_size=7.0, depth_threshold=10.0)
ITERS = 50


def blur_buffers(state, view, crop360, crop1080) -> dict:
    """name -> (depth [H, W], camera): the settled pool's cell splats in
    640x360 and 1920x1080 depth buffers (R=6 and 8), cut to the two render
    loops' crops ("crop360", "crop1080"), and the full frames with a 24 x 40
    patch at depth 1.5 a third of the way in, where the filter size is 100
    ("near360", "near1080")."""
    bufs = {}
    for cam, crop, key in ((Camera(width=640, height=360), crop360, "360"),
                           (Camera(width=1920, height=1080), crop1080, "1080")):
        cells = kx.extract_cell_splats(state, view, cam)
        depth = splat_cells(cells, cam, 1.0, 6 if cam.width < 1000 else 8).depth
        y0, x0, ch, cw = crop
        bufs["crop" + key] = (depth[y0:y0 + ch, x0:x0 + cw].contiguous(), cam)
        near = depth.clone()
        near[cam.height // 3:cam.height // 3 + 24, cam.width // 3:cam.width // 3 + 40] = 1.5
        bufs["near" + key] = (near.contiguous(), cam)
    return bufs


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time a call: CUDA events around `iters` calls queued behind a
    device sleep, so that the host's enqueue time is hidden (the device's
    time from the first kernel's start to the last one's end, the gaps
    between kernels included), after one call to warm. If the sleep ended
    before the calls were all queued, it is taken again, longer.
    (torch.profiler's kernel sums over such a run came back partial on the
    card now and then: 0.0098 ms a call for a kernel of 0.06.)"""
    fn()
    torch.cuda.synchronize()
    hold = 1e-3  # seconds of sleep, at about 2 GHz
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold * 2e9))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued = time.perf_counter() - t0
        end.record()
        drained = start.query()
        end.synchronize()
        if not drained:
            return start.elapsed_time(end) / iters
        hold = 2 * max(hold, queued)
    raise RuntimeError("the host could not queue the calls ahead of the device")


def host_ms(fn, iters: int = ITERS) -> float:
    """The host's time a call to enqueue `iters` calls, from an idle device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def split_ms(fn) -> tuple[float, float, float]:
    """(event ms, device ms, host ms) a call of `fn`."""
    return cuda_time_ms(fn, iters=ITERS), device_ms(fn), host_ms(fn)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_render_kernels needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    pool = benchmark_scene(N_POOL, device=dev)
    win = pool_window(pool)
    state = settle(win, win.init(pool.state), pool.fluid)
    cfgw = win.config
    view = default_view(pool.config.grid_res)
    cam360 = Camera(width=640, height=360)
    crops = (recipe_360(pool.config, view).crop,
             recipe_1080(pool.config, state, cfgw.grid_res, view).crop)
    grid = kp.p2g_update(state, cfgw, pool.fluid)
    rs = kx.render_scals_for(view, cam360)
    rows = {f"blur_depth {k} {tuple(d.shape)}": (lambda d=d, cam=cam: kb.blur_depth_kernel(
                d, cam, **BL_ARGS))
            for k, (d, cam) in blur_buffers(state, view, *crops).items()}
    rows[f"extract_cells window {cfgw.grid_res} K=8"] = lambda: kx.extract_cell_splats(
        state, view, cam360)
    rows[f"g2p_migrate_emit window {cfgw.grid_res} K=8"] = lambda: kf.g2p_migrate(
        state, grid, cfgw, pool.fluid, emit_splats=True, render_scals=rs)
    for label, fn in rows.items():
        event, device, host = split_ms(fn)
        print(f"[kernel-split] {label}: event {event:.4f} ms, device {device:.4f} ms, host "
              f"{host:.4f} ms a call [{smi}]", flush=True)


if __name__ == "__main__":
    main()
