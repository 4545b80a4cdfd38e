"""The cells at a size a CPU test run holds: the same scene functions,
drivers, reference and limits, on a small grid, a few settle substeps and
a small frame."""

from __future__ import annotations

import copy

from bench_torch import common


def small(cell: str):
    """(workload, config) of `cell`, cut to a CPU test's size."""
    from mpm_tpu_torch.models import scenes

    wl = copy.deepcopy(common.load_json("workloads", cell))
    cfg = copy.deepcopy(common.load_json("configs", wl["config"]))
    cfg["scene"]["args"] = ({"n_target": 20000} if cfg["scene"]["fn"] == "benchmark_scene"
                            else {"grid_res": 16, "box": 8.0})
    cfg["settle_substeps"] = 20
    sc = getattr(scenes, cfg["scene"]["fn"])(device="cpu", **cfg["scene"]["args"])
    cfg["sim"]["grid_res"] = list(sc.config.grid_res)
    cfg["sim"]["num_particles"] = sc.config.num_particles
    if "render" in wl:
        wl["render"] = {"width": 128, "height": 72}
    wl["trace_calls"] = 2
    return wl, cfg
