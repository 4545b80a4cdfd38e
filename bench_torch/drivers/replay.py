"""Replay of a fixed segment of a transient, for a scene that never settles
into a steady state within a window: set-up settles the configuration's
`settle_substeps` through make_step's frame of `substeps` and keeps that
state as the replay's start; the window is a closed loop of the same
frames, `replay_calls` of them from the start, after which the next
call's input is the start again, so that every window times the same
segment however fast the program steps it. Kernels P and F never write
their input (F allocates its outputs), so the start is passed back as it
is, inside the window, with no copy. The rate counts every particle of
every substep stepped, as the sim driver's; the restore is in the
window's seconds."""

from __future__ import annotations

import time

import torch

from .. import common
from ..reference import compare, sim as ref
from .sim import Driver as SimDriver


def moved(s_in, s_out, n: int) -> int:
    """Particles whose cell differs between two states, by id."""
    a, _ = compare.by_id(s_in.pos, s_in.ids, n)
    b, _ = compare.by_id(s_out.pos, s_out.ids, n)
    return int((torch.floor(a) != torch.floor(b)).any(dim=0).sum())


class Driver(SimDriver):
    def setup(self):
        sc = common.make_scene(self.cfg, self.seed, self.device)
        self.n, self.scene_config = sc.config.num_particles, sc.config
        self._entry, self.start, self.win, self.per_call = self.settled(sc)
        self.replay_calls = int(self.wl["replay_calls"])
        self.samples.prime(*self.fields(self.start), *self.fields(self.start))
        self.first_replay = self.counts(self.loop(count=self.replay_calls, sample=False))
        self.warm_block = self.replay_calls  # on the card each block of the warm-up is a replay
        self.warm()
        common.sync(self.device)

    def loop(self, seconds=None, count=None, sample=True) -> dict:
        """The window's calls from the start; "replay_end" holds the
        counters of the last whole replay's answer (read after the
        window)."""
        common.sync(self.device)
        t0 = time.perf_counter()
        calls, s, end = 0, self.start, None
        while (calls < count) if count is not None else (time.perf_counter() - t0 < seconds):
            s_in = self.start if calls % self.replay_calls == 0 else s
            s = self.call(s_in)
            calls += 1
            if sample:
                self.samples.offer(*self.fields(s_in), *self.fields(s))
            if calls % self.replay_calls == 0:
                end = (s.deferred, s.cfl_clamped)
        common.sync(self.device)
        t1 = time.perf_counter()
        self.state = s
        return {"calls": calls, "seconds": t1 - t0, "replays": calls // self.replay_calls,
                "replay_end": end}

    def counts(self, win: dict) -> dict | None:
        """Moves deferred and CFL clamps over the window's last whole
        replay, or None where it completed none."""
        if win["replay_end"] is None:
            return None
        deferred, clamped = (int(c) for c in win["replay_end"])
        return {"deferred": deferred - int(self.start.deferred),
                "cfl_clamped": clamped - int(self.start.cfl_clamped)}

    def info(self, win: dict) -> dict:
        """The sim driver's, the replays, the counters of a replay read at
        set-up and after the window (a replay is deterministic: they
        agree), and the particles whose cell a sampled call changed, a
        substep (a lower bound of kernel F's moves a substep)."""
        per = [moved(ref.State(*k[:5]), ref.State(*k[5:]), self.n) for k in self.samples.items]
        return {**super().info(win), "replay_calls": self.replay_calls, "replays": win["replays"],
                "replay_counts": {"setup": self.first_replay, "window": self.counts(win)},
                "moved_per_substep": sum(per) / (len(per) * self.per_call) if per else None}

    def release(self):
        self.start = None
        super().release()

