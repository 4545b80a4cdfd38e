"""One run of one cell: set-up, the measured (or traced) window, the
guarantees, the reference's check of the sampled answers, the result."""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

from . import common, trace
from .common import Check

FAULTS = ("unchanged", "half", "altered", "altered_vel")


class Driver:
    """A traffic driver: `setup` makes the scene from the seed, settles it
    and warms every shape the window uses; `call` is one call of the entry
    the window drives; `loop` runs the window; `release` frees the
    program's state; `gaps` reads the sampled answers against the
    reference."""

    samples_kept = 3
    warm_block = 10  # calls of the window's loop between two looks at the allocator
    warm_blocks_max = 40

    def __init__(self, wl: dict, cfg: dict, seed: int, device, fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.wl, self.cfg, self.seed = wl, cfg, seed
        self.device = torch.device(device)
        self.fault = fault
        self.samples = common.Reservoir(self.samples_kept, seed)

    def launches(self) -> dict:
        from mpm_tpu_torch.ops.cuda import g2p_migrate, p2g_update
        from mpm_tpu_torch.render import blur_kernel

        return {"p2g_update": p2g_update.launches, "g2p_migrate": g2p_migrate.launches,
                "g2p_migrate_emit": g2p_migrate.emit_launches, "blur_depth": blur_kernel.launches}

    def break_state(self, s_in, s_out):
        """The program's answer with the fault planted (test runs only)."""
        if self.fault == "unchanged":
            return s_in
        if self.fault == "half" and s_out.pos.shape == s_in.pos.shape:
            c = s_out.mass.shape[-1] // 2
            pos = s_out.pos.clone()
            pos[..., :c] = s_in.pos[..., :c]
            return s_out.replace(pos=pos)
        if self.fault in ("altered", "altered_vel"):
            k, c = torch.nonzero(s_out.mass > 0)[0].tolist()
            key = "pos" if self.fault == "altered" else "vel"
            x = getattr(s_out, key).clone()
            x[0, k, c] += 0.25
            return s_out.replace(**{key: x})
        return s_out

    def warm(self):
        """Runs the window's own loop, unsampled, in blocks of `warm_block`
        calls until two blocks in a row leave the caching allocator's
        segment count as it was (at most `warm_blocks_max` blocks): every
        shape the window uses has run, and the allocator holds what the
        window asks of it, so that no cudaMalloc falls inside the window."""
        start = segs = common.segments(self.device)
        quiet = blocks = 0
        if self.device.type != "cuda":  # no caching allocator to watch: one call warms
            self.loop(count=1, sample=False)
            self.warmed = {"warm_calls": 1, "warm_segments": 0}
            return
        while quiet < 2 and blocks < self.warm_blocks_max:
            self.loop(count=self.warm_block, sample=False)
            blocks += 1
            now = common.segments(self.device)
            quiet = quiet + 1 if now == segs else 0
            segs = now
        self.warmed = {"warm_calls": blocks * self.warm_block, "warm_segments": segs - start}

    def compare(self) -> list[Check]:
        """Each number the sampled answers read beside its limit."""
        lim = self.wl["limits"]
        return [Check(k, v, float(lim[k])) for k, v in self.gaps().items()]

    def settled(self, sc):
        """(entry, state, window, substeps a call) after the configuration's
        settle of the scene `sc`: the entry is the window engine's chunk where
        the configuration has a window, else make_step's frame of the
        workload's `substeps`."""
        from mpm_tpu_torch.ops import bucketed
        from mpm_tpu_torch.ops.step import make_step
        from mpm_tpu_torch.ops.window import YWindow

        win = None
        if "window" in self.cfg:
            w = self.cfg["window"]
            win = YWindow(sc.config, mode="cuda", substeps=w["substeps"], headroom=w["headroom"])
            state, per = win.init(sc.state), win.S

            def entry(s):
                return win.step(s, sc.fluid)
        else:
            per = int(self.wl["substeps"])
            step = make_step(sc.config, mode="cuda", substeps=per)
            state = bucketed.from_simstate(sc.state, sc.config)

            def entry(s):
                return step(s, sc.fluid)
        for _ in range(int(self.cfg["settle_substeps"]) // per):
            state = entry(state)
        return entry, state, win, per

    @staticmethod
    def fields(s) -> tuple:
        return (s.pos, s.vel, s.C, s.mass, s.ids)

    def state_checks(self, state, n: int) -> list[Check]:
        """The configuration's guarantees on the program's last state."""
        from .reference.compare import by_id

        _, bad = by_id(state.pos, state.ids, n)
        return [Check("lost", float(int(state.lost)), 0.0),
                Check("ids_bad", float(bad), 0.0),
                Check("nonfinite", float(int((~torch.isfinite(state.pos)).sum())), 0.0)]


def _metrics_for(bench: dict, cell: str, kind: str, reported) -> list[dict]:
    """BENCHMARK.json's `kind` metrics that `cell` reports: those that list
    it, and those without a list whose moved metric the driver reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device="cuda",
             fault: str | None = None, bench: dict | None = None, wl: dict | None = None,
             cfg: dict | None = None) -> dict:
    """The result line's object (without printing it)."""
    bench = bench if bench is not None else common.benchmark()
    wl = wl if wl is not None else common.load_json("workloads", cell)
    cfg = cfg if cfg is not None else common.load_json("configs", wl["config"])
    drv = common.load_module("drivers", wl["driver"]).Driver(wl, cfg, seed, device, fault)
    on_card = drv.device.type == "cuda"
    marks = {"imports_s": common.process_age_s()}
    if on_card:
        torch.zeros(1, device=drv.device)  # the CUDA context
        marks["context_s"] = common.process_age_s()
    drv.setup()
    before = drv.launches()
    setup_s = common.process_age_s()
    red = None
    marks.update(drv.warmed)
    segs = common.segments(drv.device)
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                win = drv.loop(count=int(wl["trace_calls"]))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            red = trace.reduce(trace.load(path))
        del prof
    else:
        win = drv.loop(seconds=seconds)
    peak = torch.cuda.max_memory_allocated(drv.device) if on_card else 0
    marks["cuda_mallocs_in_window"] = common.segments(drv.device) - segs
    after = drv.launches()
    checks = drv.guarantees()
    if on_card:
        want = drv.launches_due(win["calls"])
        miss = sum(abs(after[k] - before[k] - v) for k, v in want.items())
        checks.append(Check("launch_miss", float(miss), 0.0))
    ctx = {"drv": drv, "window": win, "trace": red}
    per_layer = {}
    if traced:
        for m in _metrics_for(bench, cell, "per_layer", drv.reports):
            val = common.load_module("metrics", m["name"]).read(ctx)
            if val is not None:
                per_layer[m["name"]] = {"value": val, "unit": m["unit"]}
    info = {"seed": seed, "setup_marks": marks, **drv.info(win)}
    drv.release()
    t_ref = time.perf_counter()
    checks += drv.compare()
    ref_s = time.perf_counter() - t_ref
    correct = all(c.ok for c in checks)
    if traced:
        metrics = per_layer
    else:
        metrics = {}
        e2e = drv.end_to_end(win)
        e2e["setup_s"] = setup_s
        info["end_to_end"] = e2e
        for m in _metrics_for(bench, cell, "end_to_end", drv.reports):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(drv.device) if on_card else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["calls"],
           "failed": sum(1 for c in checks if not c.ok), "metrics": metrics, "device": dev}
    if red is not None:
        dev["busy_s"] = red.busy_s
        dev["window_s"] = red.window_s
        out["breakdown"] = {"device_ops": red.top_ops(), "idle_gaps": red.top_gaps()}
    out["info"] = {**info, "reference_s": ref_s}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def report(out: dict) -> None:
    """The run's details, then each compared number beside its limit, as
    the last lines on stderr; the result, without the details, as the last
    line on stdout."""
    info = out.pop("info")
    sys.stdout.flush()
    print("info " + json.dumps(info), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
