"""The frame driver's rendered closed loop (drivers/frame.py, inherited
whole) with the per-pixel thickness pass on: the workload's "ssfr" keys
(thickness_pass, thickness_scale, thickness_blur_radius) go to the
frame's SSFRParams, so each frame adds splat.thickness_deposit over kernel
F's emitted cell splats and ssfr.thickness_map (on the card one replay of
the frame step's CUDA graph of both), and SH shades with the map.
The pass's two counters are held at one a frame (check `launch_miss`),
and the reference renders each sampled frame with the same pass
(reference/thickness.py)."""

from __future__ import annotations

import dataclasses

import torch

from .. import common
from ..reference import compare, render as rref, sim as ref, thickness as rthick
from .frame import Driver as Frame


class Driver(Frame):
    def setup(self):
        from mpm_tpu_torch.render import SSFRParams, make_full_frame_step

        self.warm = lambda: None  # the base set-up's frame is replaced before it is warmed
        try:
            super().setup()
        finally:
            del self.warm
        self.rc = dataclasses.replace(self.rc, ssfr=SSFRParams(**self.wl["ssfr"]))
        self._frame = make_full_frame_step(self.frame_cfg, self.rc, self.per_call)
        self.warm()
        common.sync(self.device)

    def launches(self) -> dict:
        from mpm_tpu_torch.render import splat, ssfr

        return {**super().launches(), "thickness_deposit": splat.thickness_deposits,
                "thickness_map": ssfr.thickness_maps}

    def launches_due(self, calls: int) -> dict:
        return {**super().launches_due(calls), "thickness_deposit": calls, "thickness_map": calls}

    def gaps(self, control: bool = False) -> dict:
        """drivers/frame.Driver.gaps with the reference's frame rendered with
        the workload's thickness pass."""
        p = ref.Params.from_config(self.cfg)
        r, v, grid = self.wl["render"], self.cfg["view"], self.cfg["sim"]["grid_res"]
        t = self.wl["ssfr"]
        cam = rref.Cam(width=r["width"], height=r["height"])
        view = rref.scene_view(grid, v["eye_offset"], v["target_offset"])
        crop = rref.crop_for(cam, view, grid)

        def render(s, cdt):
            return rthick.frame(s.pos.to(cdt), s.vel, s.mass, view, cam, crop,
                                t["thickness_scale"], t["thickness_blur_radius"])

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
