"""A traced window of a sharded cell read card by card: each device's own
union of activity, beside the program's spans (bench_torch/spans.py).

trace.reduce takes the union of the activity of every device, so one busy
card hides three idle ones, and it keeps no device id; spans.reduce keeps
none either. So `of(ctx)` profiles one more window of the cell's loop, as
many calls, unsampled, after the harness's window and its checks, and keeps
from its chrome trace both the spans (spans.reduce) and each card's busy
time. The readers of the sharded cell's metrics share it through `ctx`.
The window is held to the driver's guarantees, and the driver's state (and
its air window's) is put back as the harness's window left it, as
spans.of does."""

from __future__ import annotations

import dataclasses
import os
import tempfile

from . import spans, trace


@dataclasses.dataclass
class Cards:
    window_s: float
    busy_s: dict  # device index -> seconds of that device's union of activity in the window

    def idle_share(self, device) -> float:
        """1 - the device's busy time / the window (1 for a device with no activity)."""
        return 1.0 - self.busy_s.get(device, 0.0) / self.window_s


def _device(e: dict):
    """The device index of a device event: its `device` argument, else its
    process id (the profiler puts each device's activity in a process of
    its own)."""
    args = e.get("args", {})
    return int(args["device"]) if "device" in args else int(e.get("pid", -1))


def cards(events: list) -> Cards:
    """Each device's union of activity inside the one trace.WINDOW annotation."""
    win = [e for e in events if e.get("name") == trace.WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"expected one {trace.WINDOW!r} host annotation, found {len(win)}")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    by = {}
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and e.get("ph") == "X":
            s = float(e["ts"])
            a, b = max(s, t0), min(s + float(e["dur"]), t1)
            if b > a:
                by.setdefault(_device(e), []).append((a, b))
    busy = {d: sum(e - s for s, e in spans._merged(iv)) * 1e-6 for d, iv in by.items()}
    return Cards(window_s=(t1 - t0) * 1e-6, busy_s=busy)


def of(ctx: dict):
    """(spans.Spans or None, Cards or None) of one more traced window of
    `ctx`'s loop (made once a run and kept in `ctx`); (None, None) without
    a traced run. The spans are None where the window holds no program span,
    the cards None where it holds no device activity."""
    if "shard_trace" not in ctx:
        ctx["shard_trace"] = _profile_again(ctx) if ctx["trace"] is not None else (None, None)
    return ctx["shard_trace"]


def _profile_again(ctx: dict):
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
        events = trace.load(path)
    sp, cd = spans.reduce(events, calls), cards(events)
    del events
    broken = [f"{c.name} {c.value!r} (limit {c.limit!r})" for c in drv.guarantees() if not c.ok]
    drv.state = state
    if win is not None:
        vars(win).clear()
        vars(win).update(win_vars)
    if broken:
        raise RuntimeError("the sharded trace's window broke a guarantee: " + ", ".join(broken))
    return (sp if sp.spans else None), (cd if cd.busy_s else None)
