"""Timing utilities (port of ``mpm_tpu.utils.timing``).

PyTorch returns before a CUDA device finishes, so a host clock measures the
enqueue unless the work is fenced. `fence` synchronises the device of a
result; `time_fn` and `PhaseTimer` time fenced calls on the host's clock;
`cuda_time_ms` times a callable with CUDA events.

`span(name)` is the program's one span: a profiler range while a profiler
records, so that the span lands in the chrome trace on the clock of the
device's kernels and copies, and a shared null context otherwise. Every
name starts with "mpm.".
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
# The profiler's range without record_function's op dispatch: under a
# profiler about a seventh of its host cost. It lands in the chrome trace as
# a `cpu_op` event (record_function's as a `user_annotation`), on the same
# clock.
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The context of one program span: a profiler range called `name` while
    the torch profiler records, else one shared null context (a flag read
    and an empty `with`)."""
    if _profiler._is_profiler_enabled:
        return _RANGE(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs in `span(name)` (with the
    profiler off, a direct call after the flag read)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RANGE(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def start_trace(path, device):
    """A started torch profiler of the host's activity and, on a card, the
    card's, for `end_trace` to write to `path`; None without a path."""
    if not path:
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else []))
    prof.start()
    return prof


def end_trace(prof, path) -> None:
    """Stop `start_trace`'s profiler and write its chrome trace to `path`."""
    if prof is None:
        return
    prof.stop()
    prof.export_chrome_trace(path)
    print(f"trace: {path}")

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
    """Fenced host-clock totals by phase (the MLSMPM3DFluidMultithread.cs:185-219
    analogue): each `measure` calls `fn(*args)`, fences its result and adds
    the host time to the phase's total. Under a profiler each call also
    opens the span `mpm.phase.<name>`."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    def measure(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        with span(f"mpm.phase.{name}"):
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
