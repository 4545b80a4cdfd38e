"""Where config 5's time goes: BASELINE.md's config 5 (16M particles on
256^3, sharded), the benchmark pool under the air window (headroom 4,
chunks of 10 substeps) on 4 x-slabs (parallel/domain.py), beside the same
window unsharded on the first card. The slabs are one a card on the first
four cards where four are visible, else all four on the one card. The card
tests (tests/test_torch_cuda_paths.py) and utils/pass1_variants take its
scene, windows and settle from here.

    python -m mpm_tpu_torch.utils.profile_shard

Both runs settle 150 substeps; the sharded state, gathered, must then equal
the unsharded one bit for bit, with the same window height and counters.
For each run, then: the unprofiled wall time per substep in one fenced
window of 100 substeps, and under torch.profiler one more window: the
device time by kernel and op per substep, summed over the cards, and its
share of the unprofiled substep. Needs a card.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.scenes import benchmark_scene
from ..ops.window import YWindow
from ..parallel.domain import SlabMesh, gather_bucket_state
from .timing import fenced_windows

N_CONFIG5 = 16_000_000
GRID5 = (256, 256, 256)
SLABS = 4  # slabs on the one card, the counterpart of the JAX package's CPU mesh
CHUNK = 10  # substeps a window step


def config5_windows(dev, n_target: int = N_CONFIG5, grid=GRID5, mesh: SlabMesh | None = None):
    """(scene, unsharded YWindow, YWindow over `mesh`, by default SLABS
    slabs of `dev`) of config 5: the benchmark pool on `dev`, mode "cuda",
    chunks of 10 substeps, headroom 4 (the 1M pool's window policy)."""
    sc = benchmark_scene(n_target, grid_res=grid, device=dev)
    win_u = YWindow(sc.config, mode="cuda", substeps=CHUNK, headroom=4)
    win_s = YWindow(sc.config, mode="cuda", substeps=CHUNK, headroom=4,
                    mesh=mesh if mesh is not None else SlabMesh.on(dev, SLABS))
    return sc, win_u, win_s


def settle(win: YWindow, state, fluid):
    """150 substeps through the window engine."""
    for _ in range(150 // CHUNK):
        state = win.step(state, fluid)
    return state


def cards_mesh() -> SlabMesh:
    """SLABS slabs, one a card of the first SLABS cards where as many are
    visible, else all on the first card."""
    if torch.cuda.device_count() >= SLABS:
        return SlabMesh.of([torch.device("cuda", i) for i in range(SLABS)])
    return SlabMesh.on(torch.device("cuda", 0), SLABS)


FIELDS = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def check_settled(win_u: YWindow, su, win_s: YWindow, ss) -> str:
    """Raise unless the gathered sharded state equals the unsharded one bit
    for bit, with the same window height and resizes; the line that says so."""
    g = gather_bucket_state(ss)
    differ = [f for f in FIELDS if not torch.equal(getattr(g, f), getattr(su, f))]
    if differ or win_s.wy != win_u.wy or win_s.resizes != win_u.resizes:
        raise AssertionError(f"config 5: the sharded settle differs from the unsharded one in "
                             f"{differ}; wy {win_s.wy} vs {win_u.wy}")
    return (f"equal bit for bit: {', '.join(FIELDS)}; wy {win_u.wy}, resizes {win_u.resizes}, "
            f"lost {int(su.lost)}, deferred {int(su.deferred)}, cfl_clamped "
            f"{int(su.cfl_clamped)}, ceiling {int(su.ceiling)}")


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
          f"time {busy:.4f} ms/substep under the profiler, summed over the cards ("
          f"{busy / wall:.3f} of the unprofiled substep)")
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
    mesh = cards_mesh()
    sc, win_u, win_s = config5_windows(torch.device("cuda", 0), mesh=mesh)
    su = settle(win_u, win_u.init(sc.state), sc.fluid)
    ss = settle(win_s, win_s.init(sc.state), sc.fluid)
    where = ", ".join(str(d) for d in mesh.devices)
    print(f"== config 5 settled, 150 substeps unsharded and on {SLABS} slabs ({where}): "
          + check_settled(win_u, su, win_s, ss), flush=True)
    for label, win, state in (("unsharded", win_u, su), (f"{SLABS} slabs on {where}", win_s, ss)):
        _profile(label, win, state, sc.fluid)
    del su, ss


if __name__ == "__main__":
    main()
