"""Headless closed loop over a slab mesh: each call is YWindow.step of the
sharded air window (its chunk of substeps, each of kernel P's two shard
stages and kernel F in shard mode on every slab with the halo and grid
exchanges between them, then one poll), issued when the last has returned.

The configuration's `mesh` names the slabs' devices, in x order; the scene
is made on the first and split there by the window (on the CPU every slab
is on the CPU). The rate counts every particle of every substep completed
between one synchronise of every device at each end of the window. A
sampled call keeps each slab's tensors on its own device; the reference
gets them concatenated along the cell axis on one card, by a plain
torch.cat here, not by the program's gather."""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import time

import torch

from .. import common
from ..common import Check
from ..harness import Driver as Base
from ..reference import compare, sim as ref

FIELDS = ("pos", "vel", "C", "mass", "ids")


class Driver(Base):
    reports = ("particle_steps_per_s",)

    def __init__(self, wl: dict, cfg: dict, seed: int, device, fault: str | None = None):
        super().__init__(wl, cfg, seed, device, fault)
        mesh = cfg["mesh"]
        if len(mesh["devices"]) != mesh["slabs"]:
            raise ValueError(f"the mesh names {len(mesh['devices'])} devices for "
                             f"{mesh['slabs']} slabs")
        if self.device.type == "cuda":
            self.devices = [torch.device(d) for d in mesh["devices"]]
        else:
            self.devices = [self.device] * mesh["slabs"]

    def cards(self) -> list[torch.device]:
        """The distinct devices of the mesh, in slab order."""
        return list(dict.fromkeys(self.devices))

    def sync(self) -> None:
        for d in self.cards():
            common.sync(d)

    def segments(self) -> list[int]:
        return [common.segments(d) for d in self.cards()]

    def setup(self):
        from mpm_tpu_torch.ops.window import YWindow
        from mpm_tpu_torch.parallel.domain import SlabMesh

        cfg = copy.deepcopy(self.cfg)
        args = cfg["scene"]["args"]
        for k, v in args.items():  # JSON lists are the program's tuples
            if isinstance(v, list):
                args[k] = tuple(v)
        sc = common.make_scene(cfg, self.seed, self.devices[0])
        self.n, self.fluid = sc.config.num_particles, sc.fluid
        w = self.cfg["window"]
        self.win = YWindow(sc.config, mode="cuda", substeps=w["substeps"], headroom=w["headroom"],
                           mesh=SlabMesh.of(self.devices))
        self.per_call = self.win.S
        state = self.win.init(sc.state)
        del sc
        for _ in range(int(self.cfg["settle_substeps"]) // self.per_call):
            state = self.win.step(state, self.fluid)
        self.state = state
        self.samples.prime(*self.fields(state), *self.fields(state))
        self.warm()
        self.sync()

    @staticmethod
    def fields(s) -> tuple:
        """Every slab's arrays, slab by slab."""
        return tuple(getattr(slab, f) for slab in s.slabs for f in FIELDS)

    def warm(self):
        """Base.warm over every card: blocks of the window's loop until two
        in a row leave each card's segment count as it was."""
        if self.device.type != "cuda":
            self.loop(count=1, sample=False)
            self.warmed = {"warm_calls": 1, "warm_segments": 0}
            return
        start = segs = self.segments()
        quiet = blocks = 0
        while quiet < 2 and blocks < self.warm_blocks_max:
            self.loop(count=self.warm_block, sample=False)
            blocks += 1
            now = self.segments()
            quiet = quiet + 1 if now == segs else 0
            segs = now
        self.warmed = {"warm_calls": blocks * self.warm_block,
                       "warm_segments": [b - a for a, b in zip(start, segs)]}

    def break_state(self, s_in, s_out):
        from mpm_tpu_torch.parallel.domain import ShardedState

        if self.fault == "unchanged":
            return s_in
        return ShardedState([Base.break_state(self, a, b)
                             for a, b in zip(s_in.slabs, s_out.slabs)])

    def call(self, s):
        out = self.win.step(s, self.fluid)
        return self.break_state(s, out) if self.fault else out

    def halo_bytes(self):
        """The program's running total of bytes copied between slabs, or None
        where the program keeps none."""
        from mpm_tpu_torch.parallel import domain

        return getattr(domain, "halo_bytes", None)

    def loop(self, seconds=None, count=None, sample=True) -> dict:
        self.sync()
        segs, h0 = self.segments(), self.halo_bytes()
        t0 = time.perf_counter()
        calls = 0
        s = self.state
        while (calls < count) if count is not None else (time.perf_counter() - t0 < seconds):
            s_in = s
            s = self.call(s_in)
            calls += 1
            if sample:
                self.samples.offer(*self.fields(s_in), *self.fields(s))
        self.sync()
        t1 = time.perf_counter()
        self.state = s
        if sample:  # the measured window's
            self.window_mallocs = [b - a for a, b in zip(segs, self.segments())]
            self.window_halo_bytes = None if h0 is None else self.halo_bytes() - h0
        return {"calls": calls, "seconds": t1 - t0}

    def launches(self) -> dict:
        from mpm_tpu_torch.ops.cuda import g2p_migrate, p2g_shard, p2g_update

        return {"p2g1_shard": p2g_shard.p2g1_launches, "p2g2u_shard": p2g_shard.p2g2u_launches,
                "g2p_migrate_shard": g2p_migrate.shard_launches,
                "g2p_migrate": g2p_migrate.launches, "p2g_update": p2g_update.launches}

    def launches_due(self, calls: int) -> dict:
        k = calls * self.per_call * len(self.devices)  # a launch a slab a substep
        return {"p2g1_shard": k, "p2g2u_shard": k, "g2p_migrate_shard": k, "g2p_migrate": k,
                "p2g_update": 0}

    def end_to_end(self, win: dict) -> dict:
        return {"particle_steps_per_s": self.n * self.per_call * win["calls"] / win["seconds"]}

    def concat(self, tensors, dev) -> ref.State:
        """A state's slabs (`fields` order) as one plain State on `dev`: each
        field concatenated along the cell axis."""
        s = len(self.devices)
        return ref.State(*(torch.cat([tensors[len(FIELDS) * a + i].to(dev) for a in range(s)],
                                     dim=-1) for i in range(len(FIELDS))))

    def guarantees(self) -> list[Check]:
        dev = self.devices[0]
        pos, ids = (torch.cat([getattr(s, f).to(dev) for s in self.state.slabs], dim=-1)
                    for f in ("pos", "ids"))
        _, bad = compare.by_id(pos, ids, self.n)
        nonfinite = int((~torch.isfinite(pos)).sum())
        return [Check("lost", float(int(self.state.lost)), 0.0),
                Check("ids_bad", float(bad), 0.0),
                Check("nonfinite", float(nonfinite), 0.0),
                Check("interference", float(self.win.interference), 0.0)]

    def work_slabs(self) -> tuple[list, int]:
        """(the program's last state, a BucketState a slab of its own planes;
        the cells of a plane of the window)."""
        _, wy, nz = self.win.config.grid_res
        return list(self.state.slabs), wy * nz

    def info(self, win: dict) -> dict:
        on_card = self.device.type == "cuda"
        substeps = win["calls"] * self.per_call
        hb = self.window_halo_bytes
        return {"calls": win["calls"], "seconds": win["seconds"],
                "substeps_per_call": self.per_call, "wy": self.win.wy,
                "resizes": self.win.resizes, "slabs": len(self.devices),
                "devices": [str(d) for d in self.devices],
                "memory_peak_bytes_by_card": [torch.cuda.max_memory_allocated(d) if on_card else 0
                                              for d in self.cards()],
                "cuda_mallocs_in_window_by_card": self.window_mallocs,
                "halo_bytes_per_substep": None if hb is None or not substeps else hb / substeps}

    def release(self):
        self.state = self.win = None
        if self.device.type == "cuda":
            for d in self.cards():
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def gaps(self, control: bool = False) -> dict:
        """The widest gaps by id (compare.state_gaps), over the sampled
        calls, between the program's answer (with `control`, the reference
        computed in bfloat16) and the reference, each recomputed from the
        program's own input to the call. Sampled call j is gathered on, and
        recomputed by, the mesh's card j modulo the cards, the cards at once
        (a host thread each)."""
        p = ref.Params.from_config(self.cfg)
        half = len(FIELDS) * len(self.devices)
        cards = self.cards()

        def one(j, kept) -> dict:
            dev = cards[j % len(cards)]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                s_in = self.concat(kept[:half], dev)
                want = ref.run(s_in, p, self.per_call)
                s_out = (ref.run(s_in, p, self.per_call, torch.bfloat16) if control
                         else self.concat(kept[half:], dev))
                return compare.state_gaps(s_out, want, self.n)

        items = list(enumerate(self.samples.items))
        if len(cards) > 1:
            with concurrent.futures.ThreadPoolExecutor(len(cards)) as pool:
                found = list(pool.map(lambda jk: one(*jk), items))
        else:
            found = [one(j, kept) for j, kept in items]
        worst: dict = {}
        for g in found:
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
