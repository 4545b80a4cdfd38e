"""Rendered closed loop through make_full_frame_step: each frame's
substeps (the last with kernel F's splat emission), the render chain and
the u8 tonemap on the card, then the frame's copy into pinned host memory;
at most two frames in flight. A frame counts when its pixels are on the
host: the loop waits for frame i - 1's copy after issuing frame i. With a
"window" in the configuration the scene settles through the window engine
and the frames run on its frozen window (the ceiling band then guards the
run: interference must stay 0); no cell of BENCHMARK.json uses that yet:
it waits for pool_1m.frame360 (PERF.md, Open questions)."""

from __future__ import annotations

import statistics
import time

import torch

from .. import common
from ..common import Check
from ..harness import Driver as Base
from ..reference import compare, render as rref, sim as ref


class Driver(Base):
    reports = ("frames_per_s", "frame_ms_p95")

    def setup(self):
        from mpm_tpu_torch.render import (Camera, RenderConfig, background_for_view,
                                          default_view, domain_crop, make_full_frame_step)

        sc = common.make_scene(self.cfg, self.seed, self.device)
        self.fluid, self.n = sc.fluid, sc.config.num_particles
        self.per_call = int(self.wl["substeps"])
        _, state, win, _ = self.settled(sc)
        # frames on the window's frozen height, or on the whole grid
        frame_cfg = win.config if win is not None else sc.config
        self.windowed = win is not None
        r = self.wl["render"]
        self.view = default_view(sc.config.grid_res)
        self.rc = domain_crop(RenderConfig(camera=Camera(width=r["width"], height=r["height"])),
                              sc.config, self.view)
        self.bg = background_for_view(self.rc, self.view, self.device)
        self.frame_cfg = frame_cfg
        self._frame = make_full_frame_step(frame_cfg, self.rc, self.per_call)
        self.state = state
        del sc
        on_card = self.device.type == "cuda"
        h, w = r["height"], r["width"]
        self.host = [torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=on_card)
                     for _ in range(2)]
        img = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
        self.samples.prime(*self.fields(self.state), *self.fields(self.state), img)
        del img
        self.warm()
        common.sync(self.device)

    def call(self, s):
        out, img = self._frame(s, self.fluid, (), self.view, self.bg)
        if self.fault == "altered":
            img = img.clone()
            img[:24, :24] = 255 - img[:24, :24]
        elif self.fault:
            out = self.break_state(s, out)
        return out, img

    def loop(self, seconds=None, count=None, sample=True) -> dict:
        on_card = self.device.type == "cuda"
        common.sync(self.device)
        t0 = time.perf_counter()
        ready, pending = [], None
        calls = 0
        s = self.state
        while (calls < count) if count is not None else (time.perf_counter() - t0 < seconds):
            s_in = s
            s, img = self.call(s_in)
            self.host[calls % 2].copy_(img, non_blocking=on_card)
            ev = None
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
            calls += 1
            if sample:
                self.samples.offer(*self.fields(s_in), *self.fields(s), img)
            if pending is not None:
                pending.synchronize()
                ready.append(time.perf_counter())
            pending = ev
            if not on_card:
                ready.append(time.perf_counter())
        if pending is not None:
            pending.synchronize()
            ready.append(time.perf_counter())
        common.sync(self.device)
        t1 = time.perf_counter()
        self.state = s
        return {"calls": calls, "seconds": t1 - t0, "ready": ready, "t0": t0}

    def launches_due(self, calls: int) -> dict:
        return {"p2g_update": calls * self.per_call, "g2p_migrate": calls * self.per_call,
                "g2p_migrate_emit": calls, "blur_depth": calls}

    def end_to_end(self, win: dict) -> dict:
        ready = win["ready"]
        gaps = [b - a for a, b in zip([win["t0"]] + ready[:-1], ready)]
        p95 = statistics.quantiles(gaps, n=100, method="inclusive")[94] if len(gaps) > 1 \
            else gaps[0]
        return {"frames_per_s": len(ready) / (ready[-1] - win["t0"]), "frame_ms_p95": p95 * 1e3}

    def guarantees(self) -> list[Check]:
        out = self.state_checks(self.state, self.n)
        if self.windowed:  # the ceiling counter, from the window's start on
            out.append(Check("interference", float(int(self.state.ceiling)), 0.0))
        return out

    def work_state(self):
        return self.state, self.frame_cfg

    def info(self, win: dict) -> dict:
        return {"calls": win["calls"], "seconds": win["seconds"], "crop": self.rc.crop,
                "frame_grid": list(self.frame_cfg.grid_res)}

    def release(self):
        self.state = self._frame = self.bg = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, control: bool = False) -> dict:
        """Over the sampled frames: the widest gaps by id of the state
        (compare.state_gaps) and the largest share of pixels off by more
        than 1 (px_off_pct) between the program's answer (with `control`,
        the reference computed in bfloat16) and the reference, each
        recomputed from the program's own input state."""
        p = ref.Params.from_config(self.cfg)
        r, v, grid = self.wl["render"], self.cfg["view"], self.cfg["sim"]["grid_res"]
        cam = rref.Cam(width=r["width"], height=r["height"])
        view = rref.scene_view(grid, v["eye_offset"], v["target_offset"])
        crop = rref.crop_for(cam, view, grid)

        def render(s, cdt):
            bg = rref.background(cam, view, torch.zeros((), dtype=cdt, device=self.device))
            return rref.frame(s.pos.to(cdt), s.vel, s.mass, view, cam, crop, bg)

        worst: dict = {}
        for kept in self.samples.items:
            s_in, s_out, img = ref.State(*kept[:5]), ref.State(*kept[5:10]), kept[10]
            want = ref.run(s_in, p, self.per_call)
            want_img = render(want, torch.float32)
            if control:
                s_out = ref.run(s_in, p, self.per_call, torch.bfloat16)
                img = render(s_out, torch.bfloat16)
            got = {**compare.state_gaps(s_out, want, self.n),
                   "px_off_pct": compare.px_off_pct(img, want_img)}
            for k, x in got.items():
                worst[k] = max(worst.get(k, 0.0), x)
        return worst
