"""Where a render frame's time goes on a CUDA card: the settled 1M pool's
frame loops of chip_smoke.py (utils/render_bench: 640x360 cell quality, and
1080p particle quality with surface bands) under torch.profiler.

    python -m mpm_tpu_torch.utils.profile_render [--frames 20]

For each loop it prints the unprofiled wall time per frame (3 fenced
windows, u8 frames copied to pinned host memory, as chip_smoke times them),
the plain dilation alone on the frame's z-buffer (CUDA events), the device
time by kernel and op under the profiler (CUDA self time, per frame), and
the device's busy share: profiled device time over the best unprofiled
frame time (the profiler's per-op host cost inflates a frame's wall time).
Needs a card.
"""

from __future__ import annotations

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.scenes import benchmark_scene
from ..render import background_for_view, default_view, make_full_frame_step
from ..render.extract_kernel import extract_cell_splats
from ..render.splat import buffers_from_zbuffer, extract_band_slot_splats, zbuffer_cells
from .render_bench import (N_POOL, frame_windows, pool_window, recipe_360, recipe_1080,
                           settle)
from .timing import cuda_time_ms


def dilation_ms(state, view, rc, grid_res) -> float:
    """The plain sphere dilation alone on the frame's raw z-buffer."""
    cam = rc.camera
    cells = (extract_cell_splats(state, view, cam) if rc.quality == "cell" else
             extract_band_slot_splats(state, view, cam, grid_res, rc.surface_bands))
    z = zbuffer_cells(cells, cam, crop=rc.crop)
    return cuda_time_ms(lambda: buffers_from_zbuffer(z, cam, rc.ssfr.particle_sphere_radius,
                                                     rc.max_radius_px), iters=20)


def profile_loop(pool, cfgw, rc, state, view, frames: int, label: str):
    fluid = pool.fluid
    frame = make_full_frame_step(cfgw, rc, pool.config.substeps)
    bg = background_for_view(rc, view, state.pos.device)
    state, _, _ = frame_windows(frame, state, fluid, view, bg, 3, 1)  # warm
    state, _, walls = frame_windows(frame, state, fluid, view, bg, frames, 3)
    walls = [t / frames * 1e3 for t in walls]
    dil = dilation_ms(state, view, rc, cfgw.grid_res)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            state, _ = frame(state, fluid, (), view, bg)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / frames / 1e3
    print(f"== {label}: unprofiled {', '.join(f'{w:.3f}' for w in walls)} ms/frame in 3 "
          f"windows of {frames}; dilation alone {dil:.3f} ms; device busy {busy:.3f} "
          f"ms/frame under the profiler ({busy / min(walls):.3f} of the best unprofiled "
          "frame)")
    for title, rows in (("kernels", kernels), ("ops (device time of their kernels)", ops)):
        print(f"  -- by {title}")
        for e in rows[:20]:
            print(f"  {e.self_device_time_total / frames / 1e3:9.4f} ms/frame "
                  f"{e.count / frames:8.1f} calls/frame  {e.key[:90]}")
    return state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m mpm_tpu_torch.utils.profile_render")
    p.add_argument("--frames", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    pool = benchmark_scene(N_POOL, device=dev)
    win = pool_window(pool)
    state = settle(win, win.init(pool.state), pool.fluid)
    cfgw = win.config
    view = default_view(pool.config.grid_res)  # the scene's camera, not the window's
    rc = recipe_360(pool.config, view)
    state = profile_loop(pool, cfgw, rc, state, view, args.frames,
                         f"640x360 cell quality, crop {rc.crop}")
    rc = recipe_1080(pool.config, state, cfgw.grid_res, view)
    profile_loop(pool, cfgw, rc, state, view, args.frames,
                 f"1080p particle quality, bands {rc.surface_bands}, crop {rc.crop}")


if __name__ == "__main__":
    main()
