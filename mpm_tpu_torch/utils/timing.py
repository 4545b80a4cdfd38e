"""Timing utilities (port of ``mpm_tpu.utils.timing``).

PyTorch returns before a CUDA device finishes, so a host clock measures the
enqueue unless the work is fenced. `fence` synchronises the device of a
state; `cuda_time_ms` times a callable with CUDA events.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch


def fence(state) -> None:
    """Wait until the device of `state` (a tensor, an object with a `pos`
    tensor, or a sharded state's `slabs`) has finished all queued work."""
    if hasattr(state, "slabs"):
        for s in state.slabs:
            fence(s)
        return
    t = state if isinstance(state, torch.Tensor) else state.pos
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def cuda_time_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the current CUDA device,
    between CUDA events around `iters` calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fenced_windows(step: Callable, state, fluid, calls: int, windows: int = 3):
    """`windows` windows of `calls` calls `state = step(state, fluid)`,
    each fenced by a device synchronise on both ends. Returns (state,
    seconds per window)."""
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            state = step(state, fluid)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


class FrameStats:
    """Rolling frame-time window: avg/min/max/last over `window` frames
    (the reference debug overlay's 150-frame history, debug_menu.gd:27).

    Optionally tracks a device/host split per frame (the reference's
    separate CPU and GPU frame times, debug_menu.gd:132,383,403): callers
    report `split(dev_s, host_s)`, dev the fenced device work of a frame and
    host the frame loop's own host work; `stats` then carries their
    dev_ms/host_ms averages."""

    def __init__(self, window: int = 150):
        self.times = collections.deque(maxlen=window)
        self.dev_times = collections.deque(maxlen=window)
        self.host_times = collections.deque(maxlen=window)
        self._last_t: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last_t is not None:
            self.times.append(now - self._last_t)
        self._last_t = now

    def split(self, dev_s: float, host_s: float) -> None:
        self.dev_times.append(dev_s)
        self.host_times.append(host_s)

    @property
    def stats(self) -> dict:
        if not self.times:
            return {"avg_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0, "last_ms": 0.0,
                    "fps": 0.0, "dev_ms": 0.0, "host_ms": 0.0}
        arr = np.asarray(self.times)
        out = {
            "avg_ms": float(arr.mean() * 1e3),
            "min_ms": float(arr.min() * 1e3),
            "max_ms": float(arr.max() * 1e3),
            "last_ms": float(arr[-1] * 1e3),
            "fps": float(1.0 / arr.mean()),
            "dev_ms": 0.0,
            "host_ms": 0.0,
        }
        if self.dev_times:
            out["dev_ms"] = float(np.mean(self.dev_times) * 1e3)
            out["host_ms"] = float(np.mean(self.host_times) * 1e3)
        return out
