"""Where the 2D benchmark's time goes on a CUDA card: bench2d (100k
particles, 256^2, K=4) under make_step(mode="cuda", substeps=5), the 2D
main path of chip_smoke.py, which takes its scene, warm-up and windows
from here.

    python -m mpm_tpu_torch.utils.profile_2d

Prints the unprofiled wall time per substep in chip_smoke's 3 fenced
windows of 1,000 substeps, then under torch.profiler (one more window) the
device time by kernel and op per substep, the device time of one sim2d and
one migrate2d call (the sums of their kernels), and the device's busy share
(profiled device time over the best unprofiled substep). Needs a card.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.scenes import benchmark_scene_2d
from ..ops import bucketed
from ..ops.step import make_step
from .timing import fenced_windows

SUBSTEPS = 5  # a step call
WARM_CALLS = 20
WINDOW_CALLS = 200  # 1,000 substeps a window
SIM2D_KERNELS = ("p2g_mass_tile", "p2g_coef", "p2g_force_tile", "g2p_tail")
MIGRATE2D_KERNELS = ("migrate_reject", "migrate_select", "migrate_gather")


def warm_bench2d(dev):
    """The 2D benchmark scene, its make_step(mode="cuda") and its bucket
    state after 100 substeps."""
    sc = benchmark_scene_2d(device=dev)
    step = make_step(sc.config, mode="cuda", substeps=SUBSTEPS)
    state = bucketed.from_simstate(sc.state, sc.config)
    for _ in range(WARM_CALLS):
        state = step(state, sc.fluid)
    return sc, step, state


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_2d needs a CUDA device")
    sc, step, state = warm_bench2d(torch.device("cuda", 0))
    n = WINDOW_CALLS * SUBSTEPS
    state, walls = fenced_windows(step, state, sc.fluid, WINDOW_CALLS)
    walls = [w / n * 1e3 for w in walls]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = fenced_windows(step, state, sc.fluid, WINDOW_CALLS, windows=1)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]

    def device_ms(names):
        return sum(e.self_device_time_total for e in kernels
                   if any(k in e.key for k in names)) / n / 1e3

    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    print(f"== bench2d {sc.state.num_particles} particles, grid {sc.config.grid_res}, "
          f"K={sc.config.bin_capacity}: unprofiled {', '.join(f'{w:.4f}' for w in walls)} "
          f"ms/substep in 3 windows of {n}; device busy {busy:.5f} ms/substep under the "
          f"profiler ({busy / min(walls):.3f} of the best unprofiled substep); device time "
          f"a call: sim2d {device_ms(SIM2D_KERNELS):.5f} ms, migrate2d "
          f"{device_ms(MIGRATE2D_KERNELS):.5f} ms")
    for title, rows in (("kernels", kernels), ("ops (device time of their kernels)", ops)):
        print(f"  -- by {title}")
        for e in rows[:16]:
            print(f"  {e.self_device_time_total / n / 1e3:9.5f} ms/substep "
                  f"{e.count / n:6.2f} calls/substep  {e.key[:90]}")
    if int(state.lost) != 0:
        raise AssertionError(f"bench2d lost {int(state.lost)} particles")


if __name__ == "__main__":
    main()
