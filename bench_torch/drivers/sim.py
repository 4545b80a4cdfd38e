"""Headless closed loop: each call of the entry is issued when the last
has returned. With a "window" in the configuration the entry is
YWindow.step (its chunk of substeps, then one poll); without one it is
make_step's frame of `substeps`. The rate counts every particle of every
substep completed between one synchronise at each end of the window."""

from __future__ import annotations

import time

import torch

from .. import common
from ..common import Check
from ..harness import Driver as Base
from ..reference import compare, sim as ref


class Driver(Base):
    reports = ("particle_steps_per_s",)

    def setup(self):
        sc = common.make_scene(self.cfg, self.seed, self.device)
        self.n, self.scene_config = sc.config.num_particles, sc.config
        self._entry, self.state, self.win, self.per_call = self.settled(sc)
        self.samples.prime(*self.fields(self.state), *self.fields(self.state))
        self.warm()
        common.sync(self.device)

    def call(self, s):
        out = self._entry(s)
        return self.break_state(s, out) if self.fault else out

    def loop(self, seconds=None, count=None, sample=True) -> dict:
        common.sync(self.device)
        t0 = time.perf_counter()
        calls = 0
        s = self.state
        while (calls < count) if count is not None else (time.perf_counter() - t0 < seconds):
            s_in = s
            s = self.call(s_in)
            calls += 1
            if sample:
                self.samples.offer(*self.fields(s_in), *self.fields(s))
        common.sync(self.device)
        t1 = time.perf_counter()
        self.state = s
        return {"calls": calls, "seconds": t1 - t0}

    def launches_due(self, calls: int) -> dict:
        return {"p2g_update": calls * self.per_call, "g2p_migrate": calls * self.per_call}

    def end_to_end(self, win: dict) -> dict:
        return {"particle_steps_per_s": self.n * self.per_call * win["calls"] / win["seconds"]}

    def guarantees(self) -> list[Check]:
        out = self.state_checks(self.state, self.n)
        if self.win is not None:
            out.append(Check("interference", float(self.win.interference), 0.0))
        return out

    def work_state(self):
        """The program's last state and its (windowed) SimConfig."""
        return self.state, (self.win.config if self.win is not None else self.scene_config)

    def info(self, win: dict) -> dict:
        return {"calls": win["calls"], "seconds": win["seconds"], "substeps_per_call": self.per_call,
                "wy": self.win.wy if self.win is not None else None,
                "resizes": self.win.resizes if self.win is not None else None}

    def release(self):
        self.state = self._entry = self.win = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, control: bool = False) -> dict:
        """The widest gaps by id (compare.state_gaps), over the sampled
        calls, between the program's answer (with `control`, the reference
        computed in bfloat16) and the reference, each recomputed from the
        program's own input to the call."""
        p = ref.Params.from_config(self.cfg)
        worst: dict = {}
        for kept in self.samples.items:
            s_in, s_out = ref.State(*kept[:5]), ref.State(*kept[5:])
            want = ref.run(s_in, p, self.per_call)
            if control:
                s_out = ref.run(s_in, p, self.per_call, torch.bfloat16)
            for k, v in compare.state_gaps(s_out, want, self.n).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
