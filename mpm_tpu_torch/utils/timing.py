"""Timing utilities (port of ``mpm_tpu.utils.timing``).

PyTorch returns before a CUDA device finishes, so a host clock measures the
enqueue unless the work is fenced. `fence` synchronises the device of a
result; `time_fn` and `PhaseTimer` time fenced calls on the host's clock
(the reference's per-phase spans); `cuda_time_ms` times a callable with
CUDA events.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch


def _first_tensor(x):
    """The first tensor of a result: a tensor, a tuple or list (a Grid), or
    a dataclass (a state); None if it holds none."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        items = x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = [getattr(x, f.name) for f in dataclasses.fields(x)]
    else:
        return None
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def fence(state) -> None:
    """Wait until the device of `state` (a tensor, a state, a grid or a
    tuple of them, or a sharded state's `slabs`) has finished all queued
    work; a result on the CPU, or without a tensor, needs no wait."""
    if hasattr(state, "slabs"):
        for s in state.slabs:
            fence(s)
        return
    t = _first_tensor(state)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 100, warmup: int = 3):
    """Time `fn(*args) -> result`, each call taking the previous result as
    its first argument (the others as given), on the host's clock between
    fences. Returns (seconds_per_iter, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        args = (out, *args[1:])
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        args = (out, *args[1:])
    fence(out)
    dt = time.perf_counter() - t0
    return dt / iters, out


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


class PhaseTimer:
    """Named phase spans, the MLSMPM3DFluidMultithread.cs:185-219 analogue:
    each `measure` calls `fn(*args)`, fences its result and adds the host
    time to the phase's total."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    def measure(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        fence(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name, tot in self.totals.items():
            n = max(self.counts[name], 1)
            lines.append(f"{name}: {tot / n * 1e3:.3f} ms/call x{n}")
        return "\n".join(lines)
