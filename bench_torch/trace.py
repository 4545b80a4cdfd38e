"""Reduction of a torch.profiler chrome trace to what the per-layer
metrics read: device activity inside the traced window, its union, the
idle gaps and what the host ran during each, and device time by name."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
WINDOW = "bench.window"
SAMPLE = "bench.sample"  # host annotation of the harness's copies of sampled calls


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float  # union of device activity inside the window
    device: list  # (name, start_us, dur_us) of device activity in the window
    gaps: list  # (host op name, seconds) of each idle gap, longest first

    def device_s(self, *keys: str, exclude: tuple[str, ...] = ()) -> float:
        """Summed seconds of the device activity whose name holds one of
        `keys` (every activity for none), less those holding an `exclude`."""
        return sum(d for n, _, d in self.device
                   if (not keys or any(k in n for k in keys))
                   and not any(x in n for x in exclude)) * 1e-6

    def count(self) -> int:
        """Device kernels, copies and sets in the window."""
        return len(self.device)

    def top_ops(self, limit: int = 10) -> list:
        """The device ops that took most time, by name without the
        argument list (at most 160 characters)."""
        by = collections.defaultdict(float)
        for n, _, d in self.device:
            by[short(n)] += d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:limit]]

    def top_gaps(self, limit: int = 10) -> list:
        by = collections.defaultdict(float)
        for n, s in self.gaps:
            by[n] += s
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:limit]]


def short(name: str) -> str:
    """A kernel's name without its argument list, cut to 160 characters."""
    if not name.startswith("void "):
        return name[:160]
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<[":
            depth += 1
        elif ch in ">]":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160].rstrip()


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce(events: list) -> Reduced:
    """The host annotation WINDOW bounds the window (from its start to its
    end, which follows the closing synchronise)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"expected one {WINDOW!r} host annotation, found {len(win)}")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    harness = _harness_correlations(events)
    dev = []
    for e in events:
        if (e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                and e.get("args", {}).get("correlation") not in harness):
            s, d = float(e["ts"]), float(e["dur"])
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                dev.append((e["name"], a, b - a))
    dev.sort(key=lambda x: x[1])
    spans = []
    cur_s = cur_e = None
    for _, s, d in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                spans.append((cur_s, cur_e))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    if cur_e is not None:
        spans.append((cur_s, cur_e))
    busy = sum(e - s for s, e in spans)
    holes = []
    prev = t0
    for s, e in spans:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        holes.append((prev, t1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                   for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                   and e.get("name") not in (WINDOW, SAMPLE)), key=lambda x: x[0])
    starts = [h[0] for h in host]
    gaps = []
    for s, e in holes:
        gaps.append((_host_at((s + e) / 2.0, host, starts), (e - s) * 1e-6))
    gaps.sort(key=lambda x: -x[1])
    return Reduced(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, device=dev, gaps=gaps)


def _harness_correlations(events: list) -> set:
    """Correlation ids of the launches and copies the host issued inside a
    SAMPLE annotation (the benchmark's own copies of sampled calls)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("name") == SAMPLE and e.get("cat") == "user_annotation"]
    if not spans:
        return set()
    return {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
            and any(s <= float(e["ts"]) <= t for s, t in spans)}


def _host_at(t: float, host: list, starts: list) -> str:
    """The innermost (shortest) host event running at time t, or "python
    between ops" where none is. Host events nest, and while one waits no
    other starts, so the 64 latest starts before t hold it."""
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 64), -1):
        s, e, n = host[j]
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else "python between ops"
