"""The program's spans over the device's activity: the host events named
"mpm.*" that mpm_tpu_torch/utils/timing.span opens while a profiler
records. `Spans.idle_by_span` splits the device's idle time by the
innermost span open at each instant; `Spans.device_s_under` gives the
device time of the work launched inside a span (by the correlation id of
the runtime or driver call that the host made inside it); `Spans.host_s`
gives the host's time in a span less its waits on the device.

The harness keeps only trace.Reduced of its traced window, which holds no
host span, and this module may not change it. So `of(ctx)` profiles a
second window of the cell's loop, as many calls, unsampled, right after the
first window and its checks, and reduces that one; the readers of the span
metrics share it through `ctx`, and every share they give is of that
window. The second window is held to the driver's guarantees, and the
driver's state (and its air window's) is put back as the first window left
it, so that `info` and every later reader see the first window's. A program
without `span` gives None, and runs nothing."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import os
import tempfile

from . import trace

PROGRAM = "mpm."  # the prefix of the program's span names
SPAN_CATS = ("user_annotation", "cpu_op")  # record_function's category, and the fast one's
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # host calls whose correlation ids name device work
# host calls that block until the device reaches them (a copy to or from
# pageable memory waits for the stream)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
         "cudaMemcpyAsync")
OUTSIDE = "outside"  # idle_by_span's key for idle time in no program span


@dataclasses.dataclass
class Spans:
    window_s: float
    calls: int  # calls of the loop in the window
    spans: list  # (name, start_us, dur_us) of the program's spans, cut to the window
    idle: list  # (start_us, end_us) of each interval without device activity, in order
    launches: list  # (ts_us, correlation) of the runtime and driver calls in the window
    corr_us: dict  # device microseconds in the window by correlation id
    waits: list  # (start_us, end_us) of the WAITS calls in the window, in order

    def names(self) -> set:
        return {n for n, _, _ in self.spans}

    def idle_by_span(self) -> dict:
        """Idle seconds by the innermost program span open at each instant,
        OUTSIDE where none is: a sweep of the idle intervals over the pieces
        of time in which each span is the innermost."""
        out = collections.defaultdict(float)
        pieces = innermost(self.spans)
        j = 0
        for a, b in self.idle:
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            covered = 0.0
            k = j
            while k < len(pieces) and pieces[k][0] < b:
                s, e, name = pieces[k]
                over = min(b, e) - max(a, s)
                if over > 0.0:
                    out[name] += over
                    covered += over
                k += 1
            if b - a > covered:
                out[OUTSIDE] += b - a - covered
        return {n: us * 1e-6 for n, us in out.items()}

    def device_s_under(self, *names: str) -> float:
        """Device seconds in the window of the activity whose correlation id
        is that of a runtime or driver call made inside a span of `names`."""
        merged = _merged((s, s + d) for n, s, d in self.spans if n in names)
        starts = [m[0] for m in merged]
        us = 0.0
        for t, corr in self.launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                us += self.corr_us.get(corr, 0.0)
        return us * 1e-6

    def host_s(self, name: str) -> float:
        """Seconds the host spent in the spans called `name`, less the time
        it waited in them in a WAITS call: the time it took to issue their
        work."""
        waits = _merged(self.waits)
        starts = [w[0] for w in waits]
        us = 0.0
        for n, s, d in self.spans:
            if n != name:
                continue
            us += d
            i = max(0, bisect.bisect_right(starts, s) - 1)
            while i < len(waits) and waits[i][0] < s + d:
                us -= max(0.0, min(s + d, waits[i][1]) - max(s, waits[i][0]))
                i += 1
        return us * 1e-6


def _merged(intervals) -> list:
    """The union of (start, end) intervals, as disjoint [start, end] in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list, calls: int) -> Spans:
    """The spans, idle intervals, launches and waits of a chrome trace inside
    its one trace.WINDOW annotation, as trace.reduce bounds it."""
    win = [e for e in events if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"expected one {trace.WINDOW!r} host annotation, found {len(win)}")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    busy, spans, launches, waits = [], [], [], []
    corr_us = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, s = e.get("cat"), float(e.get("ts", 0.0))
        args = e.get("args", {})
        if cat in trace.DEVICE_CATS:
            a, b = max(s, t0), min(s + float(e["dur"]), t1)
            if b > a:
                busy.append((a, b))
                corr_us[args.get("correlation")] += b - a
        elif cat in SPAN_CATS and str(e.get("name", "")).startswith(PROGRAM):
            a, b = max(s, t0), min(s + float(e["dur"]), t1)
            if b >= a:
                spans.append((e["name"], a, b - a))
        elif cat in LAUNCH_CATS and t0 <= s <= t1:
            if "correlation" in args:
                launches.append((s, args["correlation"]))
            if e.get("name") in WAITS:
                waits.append((s, min(s + float(e.get("dur", 0.0)), t1)))
    idle, prev = [], t0
    for a, b in sorted(busy):
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        idle.append((prev, t1))
    return Spans(window_s=(t1 - t0) * 1e-6, calls=calls, spans=spans, idle=idle,
                 launches=sorted(launches), corr_us=dict(corr_us), waits=sorted(waits))


def innermost(spans: list) -> list:
    """(start, end, name) of the disjoint pieces of time, in order, in which
    each span of `spans` ((name, start, dur)) is the innermost one open.
    The spans nest (one host thread opens them); one that outlives its
    parent is cut at the parent's end."""
    out, stack = [], []  # stack: (end, name) of the open spans, innermost last
    t = 0.0

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for name, s, d in sorted(spans, key=lambda x: (x[1], -x[2])):
        close(s)
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((min(s + d, stack[-1][0]) if stack else s + d, name))
        t = s
    close(float("inf"))
    return out


def program_has_spans() -> bool:
    from mpm_tpu_torch.utils import timing

    return hasattr(timing, "span")


def of(ctx: dict) -> Spans | None:
    """The spans of a second traced window of the cell's loop (made once a
    run and kept in `ctx`), or None where the program opens none."""
    if "spans" not in ctx:
        ctx["spans"] = _profile_again(ctx) if ctx["trace"] is not None and \
            program_has_spans() else None
    return ctx["spans"]


def _profile_again(ctx: dict) -> Spans | None:
    """Profiles `ctx`'s window again; raises where the second window breaks
    a guarantee of the driver's. The driver's state, and its air window's
    counters and height, are then as the first window left them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    drv, calls = ctx["drv"], int(ctx["window"]["calls"])
    state = drv.state
    win = getattr(drv, "win", None)
    win_vars = dict(vars(win)) if win is not None else None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if drv.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            drv.loop(count=calls, sample=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out = reduce(trace.load(path), calls)
    broken = [f"{c.name} {c.value!r} (limit {c.limit!r})" for c in drv.guarantees() if not c.ok]
    drv.state = state
    if win is not None:
        vars(win).clear()
        vars(win).update(win_vars)
    if broken:
        raise RuntimeError("the spans' window broke a guarantee: " + ", ".join(broken))
    return out if out.spans else None
