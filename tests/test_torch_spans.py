"""The port's spans (utils/timing.span) on the CPU: off, `span` hands out
one shared null context; under torch.profiler each span of a windowed
chunk and of a rendered frame lands in the exported chrome trace, nested
as documented (ops/window.py, ops/step.py, ops/cuda/p2g_update.py and
g2p_migrate.py, render/pipeline.py). On the CPU the kernel wrappers run
their plain versions, and their spans still open."""

from __future__ import annotations

import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpm_tpu_torch.models import scenes
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.render import (Camera, RenderConfig, background_for_view, default_view,
                                  domain_crop, make_full_frame_step)
from mpm_tpu_torch.utils import timing
from mpm_tpu_torch.utils.timing import PhaseTimer, span


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _spans(fn, tmp_path) -> list:
    """(name, start, end, parent name) of each `mpm.*` span of `fn()` run
    under the profiler, read back from its chrome trace, in start order;
    the parent is the innermost `mpm.*` span around it, or None."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in ("cpu_op", "user_annotation")
                    and e.get("ph") == "X" and e["name"].startswith("mpm.")),
                   key=lambda s: (s[1], -s[2]))
    out = []
    for name, s, e in spans:
        around = [p for p in spans if p[1] <= s and e <= p[2] and p != (name, s, e)]
        parent = min(around, key=lambda p: p[2] - p[1])[0] if around else None
        out.append((name, s, e, parent))
    return out


def test_span_off_is_one_shared_null_context():
    a, b = span("mpm.a"), span("mpm.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("mpm.a")
    assert isinstance(on, timing._RANGE) and not isinstance(on, contextlib.nullcontext)
    assert span("mpm.a") is a


def test_window_chunk_spans(tmp_path):
    sc = scenes.fluid_3d(grid_res=16, box=8.0, device="cpu")
    win = YWindow(sc.config, mode="cuda", substeps=2, headroom=4)
    state = win.init(sc.state)
    got = _spans(lambda: win.step(state, sc.fluid), tmp_path)
    names = [(n, p) for n, _, _, p in got]
    assert names == [("mpm.window.step", None), ("mpm.step.frame", "mpm.window.step"),
                     ("mpm.kernel.p2g", "mpm.step.frame"), ("mpm.kernel.g2p", "mpm.step.frame"),
                     ("mpm.kernel.p2g", "mpm.step.frame"), ("mpm.kernel.g2p", "mpm.step.frame"),
                     ("mpm.window.poll", "mpm.window.step")]
    # the poll follows the chunk
    frame = next(g for g in got if g[0] == "mpm.step.frame")
    poll = next(g for g in got if g[0] == "mpm.window.poll")
    assert poll[1] >= frame[2]


def test_window_resize_span(tmp_path):
    """A window too low for its fluid grows at once: the resize runs in its
    own span inside the chunk's."""
    sc = scenes.fluid_3d(grid_res=32, box=8.0, device="cpu")
    win = YWindow(sc.config, mode="cuda", substeps=1, headroom=4)
    state = win.init(sc.state)  # wy 24 over a surface at y 19
    win.headroom = 12  # the next poll wants 32
    got = _spans(lambda: win.step(state, sc.fluid), tmp_path)
    assert ("mpm.window.resize", "mpm.window.step") in [(n, p) for n, _, _, p in got]
    assert win.resizes == 1


@pytest.mark.parametrize("thickness", (False, True))
def test_frame_spans(tmp_path, thickness):
    sc = scenes.fluid_3d(grid_res=16, box=8.0, device="cpu")
    state = bucketed.from_simstate(sc.state, sc.config)
    view = default_view(sc.config.grid_res)
    rc = domain_crop(RenderConfig(camera=Camera(width=128, height=72)), sc.config, view)
    rc = dataclasses.replace(rc, ssfr=dataclasses.replace(rc.ssfr, thickness_pass=thickness))
    bg = background_for_view(rc, view, "cpu")
    frame = make_full_frame_step(sc.config, rc, 2)
    got = _spans(lambda: frame(state, sc.fluid, (), view, bg), tmp_path)
    names = [(n, p) for n, _, _, p in got]
    want = [("mpm.frame", None), ("mpm.frame.substeps", "mpm.frame"),
            ("mpm.kernel.p2g", "mpm.frame.substeps"), ("mpm.kernel.g2p", "mpm.frame.substeps"),
            ("mpm.kernel.p2g", "mpm.frame.substeps"), ("mpm.kernel.g2p", "mpm.frame.substeps"),
            ("mpm.render.splat", "mpm.frame"), ("mpm.render.dilate", "mpm.render.splat")]
    if thickness:  # the deposit, then its map before the shade
        want += [("mpm.render.thickness", "mpm.frame"), ("mpm.render.blur", "mpm.frame"),
                 ("mpm.render.thickness", "mpm.frame")]
    else:
        want += [("mpm.render.blur", "mpm.frame")]
    want += [("mpm.render.shade", "mpm.frame"), ("mpm.render.u8", "mpm.frame")]
    assert names == want


def test_phase_timer_opens_phase_spans(tmp_path):
    pt = PhaseTimer()
    got = _spans(lambda: pt.measure("p2g", torch.ones, 4), tmp_path)
    assert [(n, p) for n, _, _, p in got] == [("mpm.phase.p2g", None)]
    assert pt.counts["p2g"] == 1


def test_profile_substep_trace_holds_every_phase(tmp_path):
    """utils/profile_substep.py --trace's path on the CPU: `start_trace` and
    `end_trace` around `time_phases` write a chrome trace holding each
    phase's `mpm.phase.*` spans, with P's and F's spans inside them."""
    from mpm_tpu_torch.utils import profile_substep

    sc = scenes.benchmark_scene(3000, device="cpu")
    state = bucketed.from_simstate(sc.state, sc.config)
    path = tmp_path / "phases.json"
    prof = timing.start_trace(str(path), "cpu")
    profile_substep.time_phases(state, sc.config, sc.fluid, PhaseTimer(), iters=1)
    timing.end_trace(prof, str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("mpm.")]
    for phase in ("FULL substep", "P (p2g_update)", "F (g2p_migrate)", *profile_substep.PER_PASS):
        assert names.count(f"mpm.phase.{phase}") == 1, phase
    assert "mpm.kernel.p2g" in names and "mpm.kernel.g2p" in names
