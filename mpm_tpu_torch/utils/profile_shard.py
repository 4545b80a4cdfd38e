"""Where config 5's time goes on one CUDA card: BASELINE.md's config 5
(16M particles on 256^3, sharded) as chip_smoke.py runs it, the benchmark
pool under the air window (headroom 4, chunks of 10 substeps) on 4 slabs of
the card (parallel/domain.py), beside the same window unsharded.
chip_smoke takes its scene and windows from here.

    python -m mpm_tpu_torch.utils.profile_shard

For each of the two runs: settle 150 substeps, then the unprofiled wall
time per substep in one fenced window of 100 substeps, then under
torch.profiler one more window: the device time by kernel and op per
substep and the device's busy share (profiled device time over the
unprofiled substep). Needs a card.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.scenes import benchmark_scene
from ..ops.window import YWindow
from ..parallel.domain import SlabMesh
from .render_bench import settle
from .timing import fenced_windows

N_CONFIG5 = 16_000_000
GRID5 = (256, 256, 256)
SLABS = 4  # slabs on the one card, the counterpart of the JAX package's CPU mesh
CHUNK = 10  # substeps a window step


def config5_windows(dev, n_target: int = N_CONFIG5, grid=GRID5):
    """(scene, unsharded YWindow, YWindow over SLABS slabs of `dev`) of
    config 5: the benchmark pool, mode "cuda", chunks of 10 substeps,
    headroom 4 (the 1M pool's window policy)."""
    sc = benchmark_scene(n_target, grid_res=grid, device=dev)
    win_u = YWindow(sc.config, mode="cuda", substeps=CHUNK, headroom=4)
    win_s = YWindow(sc.config, mode="cuda", substeps=CHUNK, headroom=4,
                    mesh=SlabMesh.on(dev, SLABS))
    return sc, win_u, win_s


def _profile(label: str, win: YWindow, state, fluid) -> None:
    calls = 10  # 100 substeps
    n = calls * CHUNK
    state, walls = fenced_windows(win.step, state, fluid, calls, windows=1)
    wall = walls[0] / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = fenced_windows(win.step, state, fluid, calls, windows=1)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    print(f"== config 5 {label}: window wy={win.wy}, unprofiled {wall:.4f} ms/substep; device "
          f"busy {busy:.4f} ms/substep under the profiler ({busy / wall:.3f} of the "
          f"unprofiled substep)")
    for title, rows in (("kernels", kernels), ("ops (device time of their kernels)", ops)):
        print(f"  -- by {title}")
        for e in rows[:14]:
            print(f"  {e.self_device_time_total / n / 1e3:9.5f} ms/substep "
                  f"{e.count / n:6.2f} calls/substep  {e.key[:90]}")
    if int(state.lost) != 0 or win.interference != 0:
        raise AssertionError(f"config 5 {label}: lost {int(state.lost)}, interference "
                             f"{win.interference}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_shard needs a CUDA device")
    sc, win_u, win_s = config5_windows(torch.device("cuda", 0))
    for label, win in (("unsharded", win_u), (f"{SLABS} slabs", win_s)):
        state = settle(win, win.init(sc.state), sc.fluid)
        _profile(label, win, state, sc.fluid)
        del state


if __name__ == "__main__":
    main()
