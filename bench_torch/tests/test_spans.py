"""bench_torch/spans.py's reading of the program's spans, on small
synthetic chrome traces whose idle and device seconds are counted by hand:
the idle time by innermost `mpm.*` span, the device time launched inside a
span, the host's time in a span less its waits, the five readers of them;
that the spans change nothing trace.reduce gives but the names of the idle
gaps they cover; that the second window leaves the driver as the first left
it and is held to its guarantees; and, on the CPU, a traced run of a small
cell that reports the five metrics, and none where the program has no
`span`."""

from __future__ import annotations

import pytest
import torch

from bench_torch import common, harness, spans, trace
from bench_torch.common import Check
from bench_torch.tests.small import small
from mpm_tpu_torch.utils.timing import span

READERS = ("driver_idle_share.sim", "launch_idle_share.sim", "frame_host_ms.frame",
           "render_idle_ms.frame", "dilate_device_ms.frame")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _chunk_trace():
    """One windowed chunk of two halves and its poll (microseconds):
    device busy [150, 250), [420, 560), [640, 660)."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("user_annotation", "mpm.window.step", 0, 900),
        _x("user_annotation", "mpm.step.frame", 10, 590),
        _x("user_annotation", "mpm.kernel.p2g", 20, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 100, 10, corr=1),
        _x("kernel", "void mpm::p2g_mass_tile<3>(x)", 150, 100, corr=1),
        _x("user_annotation", "mpm.kernel.g2p", 300, 100),
        _x("cuda_driver", "cuLaunchKernel", 380, 10, corr=2),
        _x("kernel", "void mpm::g2p_tail<3>(x)", 420, 140, corr=2),
        _x("user_annotation", "mpm.window.poll", 600, 100),
        _x("cuda_runtime", "cudaMemcpyAsync", 610, 80, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 640, 20, corr=3),
    ]


def _frame_trace():
    """Two frames of 300 us each, spans as the fast record function's
    `cpu_op`s: substeps (P's launch), splat with its dilation (one launch),
    u8 (a 30 us wait on the stream, one launch)."""
    ev = [_x("user_annotation", trace.WINDOW, 0, 1000)]
    for f, t in enumerate((0, 500)):
        c = 10 * (f + 1)
        ev += [
            _x("cpu_op", "mpm.frame", t, 300),
            _x("cpu_op", "mpm.frame.substeps", t, 100),
            _x("cpu_op", "mpm.kernel.p2g", t + 10, 40),
            _x("cuda_runtime", "cudaLaunchKernel", t + 40, 5, corr=c + 1),
            _x("kernel", "void mpm::p2g_force_tile<3>(x)", t + 60, 100, corr=c + 1),
            _x("cpu_op", "mpm.render.splat", t + 100, 100),
            _x("cpu_op", "mpm.render.dilate", t + 120, 70),
            _x("cuda_runtime", "cudaLaunchKernel", t + 150, 5, corr=c + 2),
            _x("kernel", "void at::native::reduce_kernel<512>(x)", t + 200, 60, corr=c + 2),
            _x("cpu_op", "mpm.render.u8", t + 250, 50),
            _x("cuda_runtime", "cudaStreamSynchronize", t + 255, 30),
            _x("cuda_runtime", "cudaLaunchKernel", t + 290, 5, corr=c + 3),
            _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(x)", t + 300, 20,
               corr=c + 3),
        ]
    return ev


def _ctx(events, calls):
    return {"trace": trace.reduce(events), "window": {"calls": calls}, "drv": None,
            "spans": spans.reduce(events, calls)}


def _read(name, ctx):
    return common.load_module("metrics", name).read(ctx)


def test_idle_by_span_and_device_under_a_chunk():
    red = spans.reduce(_chunk_trace(), 1)
    idle = red.idle_by_span()
    want = {"mpm.window.step": 210, "mpm.step.frame": 150, "mpm.kernel.p2g": 100,
            "mpm.kernel.g2p": 100, "mpm.window.poll": 80, spans.OUTSIDE: 100}
    assert set(idle) == set(want)
    for name, us in want.items():
        assert idle[name] == pytest.approx(us * 1e-6), name
    whole = trace.reduce(_chunk_trace())
    assert whole.busy_s == pytest.approx(260e-6)
    assert sum(idle.values()) == pytest.approx(whole.window_s - whole.busy_s)
    for names, us in ((("mpm.kernel.p2g",), 100), (("mpm.kernel.g2p",), 140),
                      (("mpm.window.poll",), 20), (("mpm.step.frame",), 240),
                      (("mpm.window.step",), 260), (("mpm.step.frame", "mpm.kernel.p2g"), 240),
                      (("mpm.window.resize",), 0)):
        assert red.device_s_under(*names) == pytest.approx(us * 1e-6), names
    ctx = _ctx(_chunk_trace(), 1)
    assert _read("driver_idle_share.sim", ctx) == pytest.approx(44.0)
    assert _read("launch_idle_share.sim", ctx) == pytest.approx(20.0)


def test_frame_readers():
    red = spans.reduce(_frame_trace(), 2)
    idle = red.idle_by_span()
    want = {"mpm.frame.substeps": 40, "mpm.kernel.p2g": 80, "mpm.render.dilate": 60,
            "mpm.render.splat": 20, "mpm.render.u8": 80, spans.OUTSIDE: 360}
    assert set(idle) == set(want)
    for name, us in want.items():
        assert idle[name] == pytest.approx(us * 1e-6), name
    assert red.device_s_under("mpm.render.dilate") == pytest.approx(120e-6)
    assert red.device_s_under("mpm.render.splat") == pytest.approx(120e-6)
    assert red.device_s_under("mpm.frame") == pytest.approx(360e-6)
    assert red.host_s("mpm.frame") == pytest.approx(540e-6)
    assert red.host_s("mpm.render.u8") == pytest.approx(40e-6)
    assert red.host_s("mpm.render.splat") == pytest.approx(200e-6)
    ctx = _ctx(_frame_trace(), 2)
    assert _read("frame_host_ms.frame", ctx) == pytest.approx(0.27)
    assert _read("render_idle_ms.frame", ctx) == pytest.approx(0.08)
    assert _read("dilate_device_ms.frame", ctx) == pytest.approx(0.06)


@pytest.mark.parametrize("events", (_chunk_trace, _frame_trace))
def test_spans_change_only_the_gap_names(events):
    full = events()
    bare = [e for e in full if not e["name"].startswith(spans.PROGRAM)]
    a, b = trace.reduce(full), trace.reduce(bare)
    assert (a.window_s, a.busy_s, a.device, a.count(), a.top_ops()) == \
        (b.window_s, b.busy_s, b.device, b.count(), b.top_ops())
    assert any(n.startswith(spans.PROGRAM) for n, _ in a.gaps)
    renamed = [("python between ops" if n.startswith(spans.PROGRAM) else n, s) for n, s in a.gaps]
    assert sorted(renamed) == sorted(b.gaps)
    assert not spans.reduce(bare, 1).spans


class _NoLoop:
    def loop(self, **kw):
        raise AssertionError("a program without spans is not traced again")


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_spans(name, monkeypatch):
    assert _read(name, {**_ctx(_chunk_trace(), 2), "spans": None}) is None
    assert _read(name, {"trace": None, "window": {"calls": 2}, "drv": _NoLoop()}) is None
    monkeypatch.setattr(spans, "program_has_spans", lambda: False)
    ctx = {"trace": trace.reduce(_chunk_trace()), "window": {"calls": 2}, "drv": _NoLoop()}
    assert _read(name, ctx) is None


class _Win:
    def __init__(self):
        self.resizes, self.wy = 0, 48


class _Loops:
    """A driver whose loop opens a span, steps its state and resizes its
    window; `ok` is its one guarantee."""
    device = torch.device("cpu")

    def __init__(self, ok=True):
        self.state, self.win, self.ok = 0, _Win(), ok

    def loop(self, count, sample):
        for _ in range(count):
            with span("mpm.window.step"):
                self.state += 1
        self.win.resizes += 1
        self.win.wy, self.win.grown = 56, True
        return {"calls": count}

    def guarantees(self):
        return [Check("lost", 0.0 if self.ok else 3.0, 0.0)]


def test_second_window_leaves_the_driver_as_it_was():
    drv = _Loops()
    ctx = {"trace": trace.reduce(_chunk_trace()), "window": {"calls": 3}, "drv": drv}
    sp = spans.of(ctx)
    assert sp.calls == 3 and sp.names() == {"mpm.window.step"}
    assert (drv.state, vars(drv.win)) == (0, {"resizes": 0, "wy": 48})
    assert spans.of(ctx) is sp  # one second window a run


def test_second_window_is_held_to_the_guarantees():
    drv = _Loops(ok=False)
    ctx = {"trace": trace.reduce(_chunk_trace()), "window": {"calls": 2}, "drv": drv}
    with pytest.raises(RuntimeError, match="lost 3.0"):
        spans.of(ctx)
    assert (drv.state, drv.win.resizes) == (0, 0)


@pytest.mark.parametrize("cell", ("pool_1m.sim", "flagship_3d.frame1080"))
def test_traced_run_reports_the_span_metrics(cell):
    """A traced run of a small cell on the CPU (no device activity: every
    reading is host idle) reports each span metric its cell lists."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        wl, cfg = small(cell)
        out = harness.run_cell(cell, 2**31 + 4242, 0.2, True, "cpu", wl=wl, cfg=cfg)
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in common.benchmark()["per_layer"]
            if m["name"] in READERS and cell in m["workloads"]}
    assert want and want <= set(out["metrics"])
