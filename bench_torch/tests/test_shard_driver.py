"""The sharded cell's driver on the CPU, at a cut size on 4 CPU slabs: a
sound run is correct, and each planted fault turns it false; a traced run
reports the span metrics. The per-card reading of a trace on a synthetic
two-device trace, the span readers on a synthetic sharded substep, and the
yardstick's copy of the shard kernels' work against the program's
utils/roofline.py."""

from __future__ import annotations

import copy
import types

import pytest
import torch

from bench_torch import common, harness, roofline, roofline_shard, shard_trace, spans, trace

CELL = "config5_16m.shard4"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small():
    """(workload, config) of the cell cut to a CPU test's size: the same
    scene function, driver, reference and limits on a 16 x 24 x 16 pool,
    chunks of 2 substeps, the mesh's 4 slabs."""
    wl = copy.deepcopy(common.load_json("workloads", CELL))
    cfg = copy.deepcopy(common.load_json("configs", wl["config"]))
    cfg["scene"]["args"] = {"n_target": 3000, "grid_res": [16, 24, 16]}
    cfg["sim"]["grid_res"] = [16, 24, 16]
    cfg["sim"]["num_particles"] = 3000
    cfg["window"]["substeps"] = 2
    cfg["settle_substeps"] = 4
    wl["trace_calls"] = 2
    return wl, cfg


@pytest.mark.parametrize("fault", (None,) + harness.FAULTS)
def test_fault_fails_correct(fault):
    wl, cfg = small()
    out = harness.run_cell(CELL, 2**31 + 12345, 0.2, False, "cpu", fault=fault, wl=wl, cfg=cfg)
    assert out["attempted"] >= 1
    assert out["correct"] is (fault is None), out["checks"]
    if fault is None:
        assert all(c["value"] == 0.0 for c in out["checks"].values()), out["checks"]
        assert "particle_steps_per_s" in out["metrics"] and "setup_s" in out["metrics"]


def test_traced_run_reports_the_span_metrics():
    """On the CPU there is no device activity: the span metrics read the
    host alone; the card and roofline readers give nothing."""
    wl, cfg = small()
    out = harness.run_cell(CELL, 2**31 + 4242, 0.2, True, "cpu", wl=wl, cfg=cfg)
    assert out["correct"], out["checks"]
    assert {"halo_ms_per_substep.shard", "shard_host_ms_per_substep.shard"} <= set(out["metrics"])
    assert out["metrics"]["shard_host_ms_per_substep.shard"]["value"] > 0.0
    assert out["info"]["halo_bytes_per_substep"] > 0


def _x(cat, name, ts, dur, corr=None, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if device is not None:
        args["device"] = device
        e["pid"] = device
    if args:
        e["args"] = args
    return e


def _two_cards():
    """One substep on two cards (microseconds): card 0 busy [100, 400) and
    [500, 600) with an overlap, card 1 busy [200, 300); the halo span
    launches a copy of 50 us on card 0, the substep's host time holds a
    100 us wait."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("cpu_op", "mpm.shard.substep", 0, 900),
        _x("cpu_op", "mpm.shard.halo", 10, 80),
        _x("cuda_runtime", "cudaMemcpyAsync", 20, 10, corr=1),
        _x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 100, 50, corr=1, device=0),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=2),
        _x("kernel", "void mpm::p2g_mass_tile<3>(x)", 120, 280, corr=2, device=0),
        _x("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=3),
        _x("kernel", "void mpm::p2g_mass_tile<3>(x)", 200, 100, corr=3, device=1),
        _x("cpu_op", "mpm.shard.grid", 450, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 460, 5, corr=4),
        _x("kernel", "void mpm::g2p_tail<3>(x)", 500, 100, corr=4, device=0),
        _x("cuda_runtime", "cudaStreamSynchronize", 600, 100),
    ]


def test_cards_give_each_device_its_own_share():
    c = shard_trace.cards(_two_cards())
    assert c.window_s == pytest.approx(1e-3)
    assert c.busy_s == {0: pytest.approx(400e-6), 1: pytest.approx(100e-6)}
    assert c.idle_share(0) == pytest.approx(0.6)
    assert c.idle_share(1) == pytest.approx(0.9)
    assert c.idle_share(2) == pytest.approx(1.0)  # a card with no activity
    # the union over both cards, as trace.reduce gives it, hides card 1's idle
    assert trace.reduce(_two_cards()).busy_s == pytest.approx(400e-6)


def test_shard_span_readers():
    ev = _two_cards()
    drv = types.SimpleNamespace(per_call=1, cards=lambda: [torch.device("cuda", 0),
                                                          torch.device("cuda", 1)])
    ctx = {"trace": trace.reduce(ev), "window": {"calls": 1}, "drv": drv,
           "shard_trace": (spans.reduce(ev, 1), shard_trace.cards(ev))}

    def read(name):
        return common.load_module("metrics", name).read(ctx)

    assert read("halo_ms_per_substep.shard") == pytest.approx(0.05 + 0.1)  # the copy, the F launch
    # 900 us less the synchronise and the copy's call (spans.WAITS counts every
    # cudaMemcpyAsync as a wait)
    assert read("shard_host_ms_per_substep.shard") == pytest.approx(0.79)
    assert read("card_idle_share.shard") == pytest.approx(90.0)  # card 1
    bare = [e for e in ev if not e["name"].startswith(spans.PROGRAM)]
    ctx["shard_trace"] = (spans.reduce(bare, 1), shard_trace.cards(bare))
    assert read("halo_ms_per_substep.shard") is None  # a program without the spans
    assert read("shard_host_ms_per_substep.shard") is None
    assert read("card_idle_share.shard") == pytest.approx(90.0)


@pytest.mark.parametrize("slabs", (2, 4))
def test_roofline_copy_equals_the_program(slabs):
    from mpm_tpu_torch.models.scenes import benchmark_scene
    from mpm_tpu_torch.ops import bucketed
    from mpm_tpu_torch.parallel import domain
    from mpm_tpu_torch.utils import roofline as program

    sc = benchmark_scene(3000, grid_res=(16, 24, 16), device="cpu")
    st = bucketed.from_simstate(sc.state, sc.config)
    sh = domain.shard_bucket_state(st, sc.config, domain.SlabMesh.on("cpu", slabs))
    pc = 24 * 16
    loc = 16 // slabs
    cfg = bucketed.slab_config(sc.config, loc + 2 * domain.HALO)
    theirs = domain._exchange_state_halo(sh.slabs, pc)
    ours = roofline_shard.padded_slabs(sh.slabs, pc)
    for p, q in zip(theirs, ours):
        assert torch.equal(p.mass, q.mass)
        assert roofline_shard.p2g1_shard_work(q) == program.p2g1_shard_work(p, cfg)
        assert roofline_shard.p2g2u_shard_work(q) == program.p2g2u_shard_work(p, cfg)
        assert roofline_shard.g2p_shard_work(q) == program.g2p_migrate_work(p, cfg)
    want = sum(roofline.bound_ms(*w(p, cfg))[0] for p in theirs
               for w in (program.p2g1_shard_work, program.p2g2u_shard_work)) * 1e-3
    got = roofline_shard.bound_s(sh.slabs, pc, roofline_shard.p2g1_shard_work,
                                 roofline_shard.p2g2u_shard_work)
    assert got == pytest.approx(want, rel=1e-12)
