"""The thickness cell (flagship_3d.frame1080_thickness) cut to a CPU test's
size by bench_torch/tests/small (fluid_3d on 16^3, 128x72, the workload's
thickness keys kept): the port's frame through make_full_frame_step with
the thickness pass against the benchmark's plain reference
(bench_torch/reference/thickness.py, which imports nothing of the
program), from seeded jittered states; the same frame without the pass,
and with a tenth less thickness scale, read above the cell's limit; the
pass's two call counters; the frame_thickness driver through
harness.run_cell, correct, and not correct under each planted fault."""

from __future__ import annotations

import functools

import pytest
import torch

from bench_torch import common, harness
from bench_torch.drivers import frame_thickness
from bench_torch.reference import compare, render as rref, sim as ref, thickness as rthick
from bench_torch.tests.small import small
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.render import (Camera, RenderConfig, SSFRParams, background_for_view,
                                  default_view, domain_crop, make_full_frame_step)

CELL = "flagship_3d.frame1080_thickness"
SEED = 2**31 + 6789
FIELDS = ("pos", "vel", "C", "mass", "ids")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _cut(settle: int | None = None):
    wl, cfg = small(CELL)
    if settle is not None:
        cfg["settle_substeps"] = settle
    return wl, cfg


@functools.lru_cache(maxsize=2)
def _settled(seed: int):
    """(scene, the state after the cut's settle, the reference's answer to
    a frame's substeps from it, the reference's frame of that answer with
    the workload's pass)."""
    wl, cfg = _cut()
    sc = common.make_scene(cfg, seed, "cpu")
    s0 = make_step(sc.config, mode="bucketed", substeps=int(cfg["settle_substeps"]))(
        bucketed.from_simstate(sc.state, sc.config), sc.fluid)
    want = ref.run(ref.State(*(getattr(s0, f) for f in FIELDS)), ref.Params.from_config(cfg),
                   int(wl["substeps"]))
    r, t, v, grid = wl["render"], wl["ssfr"], cfg["view"], cfg["sim"]["grid_res"]
    cam = rref.Cam(width=r["width"], height=r["height"])
    view = rref.scene_view(grid, v["eye_offset"], v["target_offset"])
    want_img = rthick.frame(want.pos, want.vel, want.mass, view, cam,
                            rref.crop_for(cam, view, grid), t["thickness_scale"],
                            t["thickness_blur_radius"])
    return sc, s0, want, want_img


def _frame_and_reference(seed: int, **ssfr):
    """(the port's u8 frame with the workload's pass changed by `ssfr`, the
    reference's frame with the workload's pass, the state gaps) of one
    frame from the seeded scene after the cut's settle."""
    wl, _ = _cut()
    sc, s0, want, want_img = _settled(seed)
    r = wl["render"]
    view = default_view(sc.config.grid_res)
    rc = domain_crop(RenderConfig(camera=Camera(width=r["width"], height=r["height"]),
                                  ssfr=SSFRParams(**{**wl["ssfr"], **ssfr})), sc.config, view)
    s1, img = make_full_frame_step(sc.config, rc, int(wl["substeps"]))(
        s0, sc.fluid, (), view, background_for_view(rc, view, "cpu"))
    return img, want_img, compare.state_gaps(s1, want, sc.config.num_particles)


@pytest.mark.parametrize("seed", [SEED, 7])
def test_thickness_frame_equals_the_reference(seed):
    img, want, gaps = _frame_and_reference(seed)
    limits = small(CELL)[0]["limits"]
    assert all(gaps[k] <= limits[k] for k in gaps), gaps
    assert compare.px_off_pct(img, want) <= limits["px_off_pct"]


@pytest.mark.parametrize("case", ["pass_off", "scale_less_a_tenth"])
def test_frame_without_the_workloads_pass_reads_above_the_limit(case):
    """The check sees the thickness: the frame with the constant thickness,
    or with thickness_scale 10% lower, is off by more than the limit."""
    t = small(CELL)[0]["ssfr"]
    change = ({"thickness_pass": False} if case == "pass_off"
              else {"thickness_scale": 0.9 * t["thickness_scale"]})
    img, want, _ = _frame_and_reference(SEED, **change)
    assert compare.px_off_pct(img, want) > small(CELL)[0]["limits"]["px_off_pct"]


def test_the_pass_counts_one_deposit_and_one_map_a_frame():
    wl, cfg = _cut(settle=2)
    drv = frame_thickness.Driver(wl, cfg, SEED, "cpu")
    drv.setup()
    before = drv.launches()
    win = drv.loop(count=3, sample=False)
    after = drv.launches()
    due = drv.launches_due(win["calls"])
    assert due["thickness_deposit"] == due["thickness_map"] == 3
    for k in ("thickness_deposit", "thickness_map"):
        assert after[k] - before[k] == due[k], k
    assert drv.rc.ssfr == SSFRParams(**wl["ssfr"])
    drv.release()


@pytest.mark.parametrize("fault", (None,) + harness.FAULTS)
def test_thickness_cell_on_the_cpu(fault):
    """Sound, the cell is correct; with the timed path broken underneath
    (harness.FAULTS) it is not."""
    wl, cfg = _cut(settle=2)
    out = harness.run_cell(CELL, SEED, 0.1, False, "cpu", fault=fault, wl=wl, cfg=cfg)
    assert out["attempted"] >= 1
    assert out["correct"] is (fault is None), out["checks"]
    if fault is None:
        assert out["checks"]["px_off_pct"]["value"] <= wl["limits"]["px_off_pct"]
