"""The harness's self-check on the CPU: BENCHMARK.json keeps to its
contract and every name in it resolves to a file; each per-layer reader
reads a small synthetic trace as expected; a run without a card exits
non-zero with no result; nothing the harness imports pulls in JAX or the
JAX package; the yardstick's copy of the roofline arithmetic equals the
program's on a small state."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import types

import pytest
import torch

from bench_torch import common, roofline, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_json_contract():
    b = common.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["bench_torch"] and b["command"][:2] == ["python3", "-m"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("bench_torch/") and (common.ROOT / c["file"]).is_file()
        assert json.loads((common.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        names.add(c["name"])
    pairs, cells = set(), set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    assert {c["config"] for c in b["workloads"]} == names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for c in m.get("workloads", cells):
            assert c in cells
            moved = e2e[m["moves"]]
            assert c in moved.get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for c in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert sum(c in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])


def test_every_cell_resolves():
    b = common.benchmark()
    for w in b["workloads"]:
        wl = common.load_json("workloads", w["name"])
        assert wl["name"] == w["name"] and wl["config"] == w["config"] and wl["why"] == w["why"]
        assert wl["chips"] == w["chips"]
        cfg = common.load_json("configs", wl["config"])
        assert cfg["name"] == wl["config"]
        drv = common.load_module("drivers", wl["driver"])
        for m in b["end_to_end"]:
            if w["name"] in m.get("workloads", ()):
                assert m["name"] in drv.Driver.reports
    for m in b["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)


def _synthetic_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 1000.0}]
    kern = [("void mpm::p2g_mass_tile<3>(x)", 100, 50), ("void mpm::p2g_force_tile<3>(x)", 150, 50),
            ("void mpm::g2p_tail<3>(x)", 300, 100), ("void mpm::migrate_select<3>(x)", 400, 100),
            ("Memcpy DtoH (Device -> Pinned)", 700, 100)]
    for name, ts, dur in kern:
        ev.append({"ph": "X", "cat": "gpu_memcpy" if "Memcpy" in name else "kernel",
                   "name": name, "ts": float(ts), "dur": float(dur)})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 500.0,
               "dur": 400.0})
    # the harness's copy of a sampled call: left out of the device activity
    ev.append({"ph": "X", "cat": "user_annotation", "name": trace.SAMPLE, "ts": 260.0, "dur": 20.0})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 265.0,
               "dur": 5.0, "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
               "ts": 210.0, "dur": 30.0, "args": {"correlation": 99}})
    return trace.reduce(ev)


def test_trace_reduction_and_readers():
    red = _synthetic_trace()
    assert red.window_s == pytest.approx(1e-3)
    assert red.busy_s == pytest.approx(400e-6)
    assert red.count() == 5
    # gaps [500, 700) and [800, 1000) fall in the synchronise (by their midpoints)
    assert red.top_gaps()[0] == ["cudaStreamSynchronize", pytest.approx(400e-6)]
    assert red.top_gaps()[1] == ["python between ops", pytest.approx(200e-6)]
    state = types.SimpleNamespace(mass=torch.ones(8, 4))
    drv = types.SimpleNamespace(per_call=1, work_state=lambda: (None, None))
    ctx = {"trace": red, "window": {"calls": 1}, "drv": drv}
    read = {m: common.load_module("metrics", m).read for m in (
        "device_idle_share.sim", "launches_per_substep.sim", "launches_per_frame.frame",
        "render_device_ms.frame")}
    assert read["device_idle_share.sim"](ctx) == pytest.approx(60.0)
    assert read["launches_per_substep.sim"](ctx) == 5
    assert read["launches_per_frame.frame"](ctx) == 5
    assert read["render_device_ms.frame"](ctx) == pytest.approx(0.1)  # the copy alone
    # the roofline readers divide the bound of the state's work by the kernels' time
    fake = types.SimpleNamespace(p2g_update_work=lambda s, c: (3.35e12 * 50e-6, 0),
                                 g2p_migrate_work=lambda s, c, emit: (3.35e12 * 100e-6, 0),
                                 bound_ms=roofline.bound_ms)
    for name, want in (("p2g_roofline_share.sim", 50.0), ("g2p_roofline_share.sim", 50.0)):
        mod = common.load_module("metrics", name)
        mod.roofline = fake
        assert mod.read(ctx) == pytest.approx(want)
        assert mod.read({**ctx, "trace": trace.reduce(_synthetic_trace_empty())}) is None
    del state


def _synthetic_trace_empty():
    return [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 10.0}]


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run([sys.executable, "-m", "bench_torch.run", "--workload", "pool_1m.sim",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=common.ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_harness_imports_no_jax():
    code = ("import sys, bench_torch.run, bench_torch.harness, bench_torch.calibrate, "
            "bench_torch.reference.sim, bench_torch.reference.render\n"
            "from bench_torch import common\n"
            "for k in ('drivers', 'metrics'):\n"
            "    for p in (common.HERE / k).glob('*.py'):\n"
            "        common.load_module(k, p.stem)\n"
            "common.make_scene(common.load_json('configs', 'flagship_3d'), 3, 'cpu')\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mpm_tpu.'))"
            " or m == 'mpm_tpu']\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_reference_imports_nothing_of_the_program():
    for path in (common.HERE / "reference").glob("*.py"):
        src = path.read_text()
        assert "mpm_tpu" not in src and "import jax" not in src, path


def test_roofline_copy_equals_the_program():
    from mpm_tpu_torch.models import scenes
    from mpm_tpu_torch.ops import bucketed
    from mpm_tpu_torch.utils import roofline as program

    sc = scenes.fluid_3d(grid_res=16, box=8.0, device="cpu")
    st = bucketed.from_simstate(sc.state, sc.config)
    assert roofline.p2g_update_work(st, sc.config) == program.p2g_update_work(st, sc.config)
    for emit in (False, True):
        assert (roofline.g2p_migrate_work(st, sc.config, emit=emit)
                == program.g2p_migrate_work(st, sc.config, emit=emit))
    assert roofline.bound_ms(1e9, 1e12, 1e9) == program.bound_ms(1e9, 1e12, 1e9)
