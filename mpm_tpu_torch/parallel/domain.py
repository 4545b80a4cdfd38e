"""X-slab domain decomposition of the bucket state (port of the bucket half
of ``mpm_tpu.parallel.domain``, domain.py:517-746).

The JAX package runs it as one program over a device mesh (shard_map,
ppermute). Here one process drives every slab: a `SlabMesh` is a list of
torch devices, one per slab, and it may repeat a device (four slabs on one
card are the counterpart of the JAX package's virtual CPU mesh). A sharded
state (`ShardedState`) holds one BucketState per slab on its device: slab
`a` owns the nx / n x-planes from global plane a * nx / n, plane-major,
exactly the JAX package's slice of the global [.., K, C] arrays. Per
substep, on every slab:

  1. state halo: the neighbours' two nearest planes a side are copied in
     (dead planes, mass 0 and ids -1, past the global ends), so the slab
     computes its halo planes' G2P and migration itself and the overflow
     decisions at a boundary agree on both sides without a merge;
  2. stage 1 of kernel P (ops/cuda/p2g_shard.py): grid mass and pass-1
     momentum on the slab's grid of L + 2 planes;
  3. grid-mass exchange: the two end planes a side, incomplete here, are
     replaced by the neighbours' complete ones (zero past the global ends);
  4. stage 2 of kernel P: force and grid update from the exact mass;
  5. grid-velocity exchange, as 3;
  6. kernel F in shard mode (G2P, tail, migration; with the render's splat
     emission on request) into a new padded slab, whose own planes the
     chunk returns after its last substep.

The exchanges fill planes in place; nothing rebuilds a padded slab or a
grid (spans `mpm.shard.halo`, `mpm.shard.grid`; the bytes they move
between slabs add to `halo_bytes`). A chunk's first substep pads its input
slabs into new buffers (the full exchange: own planes and halo, a launch a
slab), so that a chunk never writes its input state. Kernel F's output is
a padded slab, and its own planes are the next substep's padded interior:
later substeps overwrite only its halo planes, and every grid exchange only
the end planes of the stage's fresh grid (in-place fills). Each exchange is
one launch of kernel HF (ops/cuda/halo_fill.py, whose counters tell fills
from full exchanges) a slab on the slab's card, which reads the
neighbours' planes by device pointer: on the same card, or on a peer card
over NVLink. Across cards a slab that a neighbour reads records an event
after the work that made the planes, the reader's stream waits on it
before its fill and records a second event after it, and the producer's
stream waits on that one, so that neither its next kernels nor the caching
allocator's reuse of a freed block overwrite what is read before it is
read: the two-way barrier of a cross-card copy, once a slab an exchange.
Slabs of one card share its stream, whose order alone orders them. A pair
of cards without peer access fills by copy_ into the same planes; the CPU
and mode "bucketed" take the plain version (a copy_ or fill_ of each
slice). Config 5 on four cards runs bit-equal to one card's unsharded
window over 150 substeps (utils/profile_shard). Counters count the slab's
own planes only (the kernels' gate) and each slab's deltas are summed once
per frame (span `mpm.shard.counters`), as the JAX package's psum.

The sort-based sharded step of the binned engine (domain.py:49-514) comes
after it: `ShardConfig`, `shard_scene`, `make_sharded_step`, `gather_live`
on linear per-slab states (the section at the end).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from ..core.params import FluidParams, SimConfig
from ..core.state import Grid, SimState
from ..ops import binned, reference, transfer
from ..ops.bucketed import BucketState, Slab, from_simstate, slab_config
from ..ops.cuda import halo_fill, p2g_shard
from ..ops.cuda.extract_cells import cell_splats_plain
from ..ops.cuda.g2p_migrate import g2p_migrate, g2p_migrate_plain
from ..ops.cuda.halo_fill import Seg
from ..ops.grid import update_grid
from ..ops.interact import Interaction
from ..utils.timing import span, spanned

COUNTERS = ("lost", "cfl_clamped", "deferred", "ceiling")
FIELDS = ("pos", "vel", "C", "mass", "ids")
DEAD = {"pos": 0, "vel": 0, "C": 0, "mass": 0, "ids": -1}  # a dead plane's values
HALO = 2  # state halo planes a side (the migration's reach plus one)

halo_bytes = 0  # bytes copied between slabs so far: state halo and grid exchanges


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """The devices of the slabs, in x order; a device may repeat."""

    devices: tuple[torch.device, ...]

    @staticmethod
    def of(devices: Sequence) -> "SlabMesh":
        return SlabMesh(tuple(torch.device(d) for d in devices))

    @staticmethod
    def on(device, n: int) -> "SlabMesh":
        """n slabs on one device."""
        return SlabMesh.of([device] * n)

    @property
    def n(self) -> int:
        return len(self.devices)


@dataclasses.dataclass
class ShardedState:
    """One BucketState per slab, each on its mesh device. Every slab's
    counters hold the totals over all slabs."""

    slabs: list[BucketState]

    @property
    def lost(self) -> torch.Tensor:
        return self.slabs[0].lost

    @property
    def cfl_clamped(self) -> torch.Tensor:
        return self.slabs[0].cfl_clamped

    @property
    def deferred(self) -> torch.Tensor:
        return self.slabs[0].deferred

    @property
    def ceiling(self) -> torch.Tensor:
        return self.slabs[0].ceiling


def slab_planes(config: SimConfig, n: int) -> int:
    """Planes a slab owns; raises unless nx splits into n slabs of >= 2."""
    nx = config.grid_res[0]
    if config.dim != 3:
        raise ValueError("the slab decomposition is 3D")
    if n < 1 or nx % n or nx // n < HALO:
        raise ValueError(f"{n} slabs must divide grid x={nx} into slabs of >= {HALO} planes")
    return nx // n


def _plane_cells(config: SimConfig) -> int:
    return config.num_cells // config.grid_res[0]


def _planes(x: torch.Tensor, pc: int, lo: int, hi: int) -> torch.Tensor:
    """Planes [lo, hi) of a [..., C] array."""
    return x[..., lo * pc:hi * pc]


def shard_bucket_state(bstate: BucketState, config: SimConfig, mesh: SlabMesh) -> ShardedState:
    """Split a whole-grid BucketState into the mesh's slabs."""
    loc, pc = slab_planes(config, mesh.n), _plane_cells(config)
    slabs = []
    for a, dev in enumerate(mesh.devices):
        arrays = {f: _planes(getattr(bstate, f), pc, a * loc, (a + 1) * loc).to(dev).contiguous()
                  for f in FIELDS}
        counters = {f: getattr(bstate, f).to(dev).clone() for f in COUNTERS}
        slabs.append(BucketState(**arrays, **counters))
    return ShardedState(slabs)


def gather_bucket_state(state: ShardedState) -> BucketState:
    """The inverse of shard_bucket_state: the slabs concatenated into one
    BucketState on the first slab's device, slot for slot."""
    dev = state.slabs[0].device
    arrays = {f: torch.cat([getattr(s, f).to(dev) for s in state.slabs], dim=-1)
              for f in FIELDS}
    counters = {f: getattr(state, f).to(dev) for f in COUNTERS}
    return BucketState(**arrays, **counters)


def _plane_bytes(x: torch.Tensor, planes: int, pc: int) -> int:
    """Bytes of `planes` planes of a [..., C] array."""
    return x.numel() // x.shape[-1] * planes * pc * x.element_size()


def _state_segs(n: int, loc: int, full: bool) -> list[list[Seg]]:
    """Slab by slab, the segments of a state exchange over a table of the n
    padded slabs' fields (slab-major, FIELDS order): each field's HALO
    planes a side from the neighbour's nearest own planes, dead planes past
    the global ends. With `full`, the n unpadded slabs' fields follow in
    the table, and the own planes come from there too; else the own planes
    are in place and the neighbours' sit at HALO in their padded slabs."""
    nf = len(FIELDS)
    base = 0 if full else HALO  # the first own plane of a source

    def src(b: int, i: int) -> int:
        return (n + b if full else b) * nf + i

    out = []
    for a in range(n):
        segs = []
        for i, f in enumerate(FIELDS):
            dst = a * nf + i
            if full:
                segs.append(Seg(dst, HALO, src(a, i), 0, loc))
            segs.append(Seg(dst, 0, src(a - 1, i), base + loc - HALO, HALO) if a > 0
                        else Seg(dst, 0, None, 0, HALO, DEAD[f]))
            segs.append(Seg(dst, HALO + loc, src(a + 1, i), base, HALO) if a < n - 1
                        else Seg(dst, HALO + loc, None, 0, HALO, DEAD[f]))
        out.append(segs)
    return out


def _grid_segs(n: int, loc: int) -> list[list[Seg]]:
    """Slab by slab, the segments of a grid exchange over the n slabs'
    grids ([..., (loc+6) * pc]: grid plane j is global plane x0 - 1 + j,
    complete on [2, loc+3]): planes 0-1 from the left neighbour's loc,
    loc+1, planes loc+4, loc+5 from the right one's 4, 5, zero past the
    global ends."""
    return [[Seg(a, 0, a - 1, loc, 2) if a > 0 else Seg(a, 0, None, 0, 2),
             Seg(a, loc + 4, a + 1, 4, 2) if a < n - 1 else Seg(a, loc + 4, None, 0, 2)]
            for a in range(n)]


class _Exchange:
    """The slab exchanges of n slabs of `loc` planes: the segments of each
    kind ("full", "state", "grid"), run by kernel HF on CUDA tensors (its
    plans kept by the table's layout) or by its plain version on the CPU
    and with `plain`."""

    def __init__(self, n: int, loc: int, pc: int, plain: bool):
        self.n, self.loc, self.pc, self.plain = n, loc, pc, plain
        self.segs = {"full": _state_segs(n, loc, True), "state": _state_segs(n, loc, False),
                     "grid": _grid_segs(n, loc)}
        self._plans: dict = {}

    def run(self, kind: str, table: list[torch.Tensor]) -> None:
        if self.plain or table[0].device.type != "cuda":
            halo_fill.fill_plain(table, self.segs[kind], self.pc)
            return
        # a plan holds its table's row counts, byte strides and cards
        key = (kind, tuple((t.shape, t.stride(), t.dtype, t.get_device()) for t in table))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = halo_fill.Plan(table, self.segs[kind], self.pc,
                                                     full=kind == "full")
        plan.run(table, self.pc)


@functools.cache
def _exchange(n: int, loc: int, pc: int, plain: bool) -> _Exchange:
    return _Exchange(n, loc, pc, plain)


def _state_halo_bytes(slab: BucketState, n: int, pc: int) -> int:
    """Bytes a state exchange moves between slabs: each of the n - 1
    boundaries sends HALO planes of every field each way."""
    return 2 * (n - 1) * sum(_plane_bytes(getattr(slab, f), HALO, pc) for f in FIELDS)


@spanned("mpm.shard.halo")
def _exchange_state_halo(slabs: list[BucketState], pc: int,
                         plain: bool = False) -> list[BucketState]:
    """The padded slabs, each in a new buffer: [left neighbour's last 2
    planes | own | right neighbour's first 2 planes]; dead planes past the
    global ends (the full exchange, a launch a slab; with `plain`, or on
    the CPU, its plain version). The counters are the slabs'."""
    global halo_bytes
    n, loc = len(slabs), slabs[0].mass.shape[-1] // pc
    ex = _exchange(n, loc, pc, plain)
    srcs = [getattr(s, f) for s in slabs for f in FIELDS]
    bufs = [torch.empty((*x.shape[:-1], (loc + 2 * HALO) * pc), dtype=x.dtype, device=x.device)
            for x in srcs]
    ex.run("full", bufs + srcs)
    halo_bytes += _state_halo_bytes(slabs[0], n, pc)
    nf = len(FIELDS)
    return [s.replace(**dict(zip(FIELDS, bufs[a * nf:(a + 1) * nf]))) for a, s in enumerate(slabs)]


@spanned("mpm.shard.halo")
def _fill_state_halo(padded: list[BucketState], pc: int,
                     plain: bool = False) -> list[BucketState]:
    """The padded slabs' halo planes, in place, from the neighbours' own
    planes (dead past the global ends): a launch a slab, or the plain
    version as _exchange_state_halo's."""
    global halo_bytes
    n, loc = len(padded), padded[0].mass.shape[-1] // pc - 2 * HALO
    _exchange(n, loc, pc, plain).run("state", [getattr(p, f) for p in padded for f in FIELDS])
    halo_bytes += _state_halo_bytes(padded[0], len(padded), pc)
    return padded


@spanned("mpm.shard.grid")
def _exchange_grid(gs: list[torch.Tensor], loc: int, pc: int,
                   plain: bool = False) -> list[torch.Tensor]:
    """In place, the incomplete end planes of each slab's grid ([..., (loc+6)
    * pc]: grid plane j is global plane x0 - 1 + j, complete on [2, loc+3])
    replaced by the neighbours' complete ones, zero past the global ends:
    a launch a slab, or the plain version as _exchange_state_halo's.
    Returns `gs`."""
    global halo_bytes
    n = len(gs)
    _exchange(n, loc, pc, plain).run("grid", gs)
    halo_bytes += 2 * (n - 1) * _plane_bytes(gs[0], 2, pc)
    return gs


def _f_kernels(padded, grid, config, fp, inter, slab, rscals):
    if rscals is None:
        return g2p_migrate(padded, grid, config, fp, inter, slab=slab), None
    return g2p_migrate(padded, grid, config, fp, inter, emit_splats=True,
                       render_scals=rscals, slab=slab)


def _f_plain(padded, grid, config, fp, inter, slab, rscals):
    out = g2p_migrate_plain(padded, grid, config, fp, inter, slab)
    if rscals is None:
        return out, None
    return out, cell_splats_plain(out.pos, out.vel, out.mass, rscals)


def _stages(mode: str):
    """(stage 1, stage 2, kernel F) of a step mode: the kernel wrappers for
    "auto" and "cuda" (each takes its plain version on the CPU), the plain
    versions for "bucketed"."""
    if mode == "bucketed":
        return p2g_shard.p2g1_shard_plain, p2g_shard.p2g2u_shard_plain, _f_plain
    if mode in ("auto", "cuda"):
        return p2g_shard.p2g1_shard, p2g_shard.p2g2u_shard, _f_kernels
    raise ValueError(f"unknown step mode: {mode}")


def make_sharded_frame_fn(config: SimConfig, mesh: SlabMesh, substeps: int | None = None,
                          mode: str = "auto"):
    """(state, fluid, interactions, render_scals=None) -> (state, splats):
    `substeps` sharded substeps; with render scalars the last one's kernel
    F emits each slab's splats of its own planes ([5, loc * pc] a slab),
    else splats is None."""
    loc = slab_planes(config, mesh.n)
    pc = _plane_cells(config)
    n_pad = loc + 2 * HALO
    cfg = slab_config(config, n_pad)
    nsub = substeps if substeps is not None else config.substeps
    stage1, stage2, kernel_f = _stages(mode)
    x0s = [a * loc - HALO for a in range(mesh.n)]
    gates = [Slab(x0=x0, go=1, c_lo=HALO, c_hi=n_pad - 1 - HALO) for x0 in x0s]
    own = slice(HALO * pc, (HALO + loc) * pc)

    plain = mode == "bucketed"

    @spanned("mpm.shard.substep")
    def substep(slabs, first, fp, inter, rscals):
        # the chunk's first substep pads its input slabs into new buffers;
        # later ones fill the halo of the last substep's padded output
        padded = (_exchange_state_halo(slabs, pc, plain) if first
                  else _fill_state_halo(slabs, pc, plain))
        g1 = [stage1(p, cfg, fp, x0) for p, x0 in zip(padded, x0s)]
        gmass = _exchange_grid([g.mass for g in g1], loc, pc, plain)
        gvel = [stage2(p, Grid(mom=g.mom, mass=m), cfg, fp, x0)
                for p, g, m, x0 in zip(padded, g1, gmass, x0s)]
        gvel = _exchange_grid(gvel, loc, pc, plain)
        out, splats = [], []
        for p, gv, m, gate in zip(padded, gvel, gmass, gates):
            s, sp = kernel_f(p, Grid(mom=gv, mass=m), cfg, fp, inter, gate, rscals)
            out.append(s)
            # the halo planes' splats come from incomplete state: dropped
            splats.append(None if sp is None else sp[:, own])
        return out, splats

    def frame(state: ShardedState, fp: FluidParams, interactions: Sequence[Interaction] = (),
              render_scals: torch.Tensor | None = None):
        totals = [getattr(state, f) for f in COUNTERS]
        slabs = [s.replace(**{f: torch.zeros((), dtype=torch.int32, device=s.device)
                              for f in COUNTERS}) for s in state.slabs]
        splats = None
        for i in range(nsub):
            rs = render_scals if i == nsub - 1 else None
            slabs, splats = substep(slabs, i == 0, fp, interactions, rs)
        if nsub:  # the own planes of the last padded slabs
            slabs = [s.replace(**{f: getattr(s, f)[..., own] for f in FIELDS}) for s in slabs]
        # each slab counted its own planes' events: the totals are the sums
        with span("mpm.shard.counters"):
            for f, c0 in zip(COUNTERS, totals):
                total = c0 + sum(getattr(s, f).to(c0.device) for s in slabs)
                slabs = [s.replace(**{f: total.to(s.device)}) for s in slabs]
        return ShardedState(slabs), (splats if render_scals is not None else None)

    return frame


def make_sharded_bucket_step(config: SimConfig, mesh: SlabMesh, substeps: int | None = None,
                             mode: str = "auto"):
    """The sharded frame step (state, fluid, interactions) -> state over a
    ShardedState: `substeps` (default config.substeps) substeps of kernel
    P's two shard stages and kernel F in shard mode on every slab (their
    plain versions under mode "bucketed" or on the CPU). Requires nx % n ==
    0 and slabs of >= 2 planes."""
    fn = make_sharded_frame_fn(config, mesh, substeps, mode)

    def step(state: ShardedState, fp: FluidParams,
             interactions: Sequence[Interaction] = ()) -> ShardedState:
        return fn(state, fp, interactions)[0]

    return step


def _check_equal(got: BucketState, want: BucketState, label: str) -> None:
    for f in (*FIELDS, *COUNTERS):
        a, b = getattr(got, f), getattr(want, f)
        if not torch.equal(a, b.to(a.device)):
            raise AssertionError(f"{label}: the sharded step's {f} differs from the "
                                 "unsharded step's")


def demo_sharded_bucket_step(n_slabs: int, device="cuda") -> None:
    """One sharded substep of a tiny scene on n_slabs slabs of one device
    (domain.py:702-746): plain f32, a y-windowed config (true-domain walls,
    the ceiling band) and bf16 vel/C storage. Each must lose no particle
    and equal the unsharded step (ops/step.make_step) slot for slot."""
    from ..models.scenes import fluid_3d
    from ..ops.step import make_step
    from ..ops.window import window_config

    mesh = SlabMesh.on(device, n_slabs)
    scene = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=device)
    config = scene.config.replace(substeps=1, bin_capacity=8)
    tall = config.replace(grid_res=(16, 32, 16))
    runs = {"f32": config, "windowed": window_config(tall, 16),
            "bf16": config.replace(storage_dtype="bfloat16")}
    for label, cfg in runs.items():
        b0 = from_simstate(scene.state, cfg)
        out = make_sharded_bucket_step(cfg, mesh, substeps=1)(
            shard_bucket_state(b0, cfg, mesh), scene.fluid)
        if int(out.lost) != 0:
            raise AssertionError(f"demo_sharded_bucket_step ({label}): lost {int(out.lost)}")
        want = make_step(cfg, substeps=1)(b0, scene.fluid)
        _check_equal(gather_bucket_state(out), want, f"demo_sharded_bucket_step ({label})")


# --------------------------------------------------------------------------
# The sort-based sharded step of the binned engine (domain.py:49-514)
# --------------------------------------------------------------------------
#
# Each slab owns the particles whose base cell lies in its x planes, in a
# linear SimState of fixed capacity with dead slots (mass 0). Per substep:
# a local sort by cell id on the slab's grid padded with one halo plane a
# side; P2G pass 1; the halo reduce (each slab adds its halo planes into
# its neighbours' edge planes); the mass halo fill; pass 2; a second,
# momentum-only reduce; the grid update with global bands; the velocity
# halo fill; G2P against the local grid with the advection tail in global
# coordinates; then migration: the slab's leftward movers sort to the front
# of its order and the rightward ones to the live tail, from where fixed
# windows of migration_capacity carry them to the neighbours' tail slots.
# The exchanges are tensor copies between slabs (`.to(device)`), each slab
# reading its neighbours' values from before the exchange, as ppermute does.

DEAD_CID = 2_000_000_000  # the flat id of a dead slot: sorts last, in no segment


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """n_shards slabs along x; each holds local_capacity particle slots, of
    which the last 2 * migration_capacity receive migrants."""

    n_shards: int
    local_capacity: int = 0
    migration_capacity: int = 0

    def local_planes(self, config: SimConfig) -> int:
        if config.grid_res[0] % self.n_shards:
            raise ValueError("grid axis 0 must divide evenly over the shards")
        return config.grid_res[0] // self.n_shards


@dataclasses.dataclass
class ShardedSimState:
    """One linear SimState of local_capacity slots per slab, on its mesh
    device, in x order."""

    slabs: list[SimState]


def _local_config(config: SimConfig, sconf: ShardConfig) -> SimConfig:
    """The padded local grid (the slab's planes and one halo plane a side),
    for tap offsets, cell counts and flags."""
    return config.replace(grid_res=(sconf.local_planes(config) + 2, *config.grid_res[1:]))


def _local_geometry(pos: torch.Tensor, alive: torch.Tensor, config: SimConfig,
                    x0: int) -> transfer.TransferGeometry:
    """The geometry against the padded local grid: the flat id uses the
    halo-shifted x plane; dead slots take DEAD_CID."""
    base_raw = torch.floor(pos).to(torch.int32)
    base = torch.stack([torch.clamp(base_raw[a], 1, config.grid_res[a] - 2)
                        for a in range(config.dim)])
    d = pos - base.to(pos.dtype) - 0.5
    lcid = base[0] - x0 + 1  # padded plane index; the interior is [1, loc_x]
    for a in range(1, config.dim):
        lcid = lcid * config.grid_res[a] + base[a]
    lcid = torch.where(alive, lcid, DEAD_CID)
    return transfer.TransferGeometry(base=base, d=d, flat_base=lcid)


def _update_grid_local(grid: Grid, cfg_local: SimConfig, config: SimConfig, fp: FluidParams,
                       x0: int) -> Grid:
    """The grid update with global boundary bands (domain.py:99-160): the
    padded plane p lies at global x = x0 + p - 1, and every band sits at
    the global grid's walls (grid_res, as the JAX package's)."""
    return update_grid(grid, cfg_local.replace(domain_res=config.grid_res), fp, x0=x0 - 1)


def _halo_reduce(grids: list[Grid], loc: int, pc: int, mom_only: bool = False) -> list[Grid]:
    """Add each slab's halo planes into its neighbours' edge planes (zero
    past the global ends). `mom_only` leaves the mass: the second reduce
    must not add the filled halo mass, the neighbour's own."""
    n = len(grids)
    out = []
    for a, g in enumerate(grids):
        mom, mass = g.mom.clone(), g.mass.clone()
        for p, src, q in ((1, a - 1, loc + 1), (loc, a + 1, 0)):
            if 0 <= src < n:
                nb = grids[src]
                mom[:, p * pc:(p + 1) * pc] += _planes(nb.mom, pc, q, q + 1).to(mom.device)
                if not mom_only:
                    mass[p * pc:(p + 1) * pc] += _planes(nb.mass, pc, q, q + 1).to(mass.device)
        out.append(Grid(mom=mom, mass=mass))
    return out


def _halo_fill(grids: list[Grid], loc: int, pc: int, mom_too: bool) -> list[Grid]:
    """Set each slab's halo planes to its neighbours' edge planes: the mass
    always (pass 2's density needs the whole neighbourhood), the momentum
    only when `mom_too` (the updated velocities for G2P), else zero so that
    the second reduce carries pass 2's contributions alone. Zero past the
    global ends."""
    n = len(grids)
    out = []
    for a, g in enumerate(grids):
        mom, mass = g.mom.clone(), g.mass.clone()
        for p, src, q in ((0, a - 1, loc), (loc + 1, a + 1, 1)):
            cols = slice(p * pc, (p + 1) * pc)
            have = 0 <= src < n
            mass[cols] = _planes(grids[src].mass, pc, q, q + 1).to(mass.device) if have else 0
            mom[:, cols] = (_planes(grids[src].mom, pc, q, q + 1).to(mom.device)
                            if have and mom_too else 0)
        out.append(Grid(mom=mom, mass=mass))
    return out


def _window(state: SimState, start: torch.Tensor, mask: torch.Tensor, p_cap: int) -> SimState:
    """p_cap slots from `start` (clamped to the state), dead where `mask`
    is false (mass 0, ids -1)."""
    n_cap = state.num_particles
    idx = torch.clamp(start + torch.arange(p_cap, device=start.device), 0, n_cap - 1)
    m = mask[idx]
    return SimState(pos=state.pos[:, idx], vel=state.vel[:, idx], C=state.C[:, :, idx],
                    mass=torch.where(m, state.mass[idx], 0.0),
                    ids=torch.where(m, state.ids[idx], -1))


def _land(state: SimState, buf: SimState, offset: int) -> SimState:
    """`buf` written into the slots from `offset`."""
    out = SimState(pos=state.pos.clone(), vel=state.vel.clone(), C=state.C.clone(),
                   mass=state.mass.clone(), ids=state.ids.clone())
    k = buf.num_particles
    out.pos[:, offset:offset + k] = buf.pos
    out.vel[:, offset:offset + k] = buf.vel
    out.C[:, :, offset:offset + k] = buf.C
    out.mass[offset:offset + k] = buf.mass
    out.ids[offset:offset + k] = buf.ids
    return out


def _to(state: SimState, dev) -> SimState:
    return SimState(pos=state.pos.to(dev), vel=state.vel.to(dev), C=state.C.to(dev),
                    mass=state.mass.to(dev), ids=state.ids.to(dev))


def sharded_substep(slabs: list[SimState], config: SimConfig, sconf: ShardConfig,
                    fp: FluidParams, interactions: Sequence[Interaction] = ()) -> list[SimState]:
    """One substep on every slab (the module section's comment)."""
    n = len(slabs)
    loc = sconf.local_planes(config)
    pc = _plane_cells(config)
    cfg_local = _local_config(config, sconf)
    p_cap = sconf.migration_capacity

    # sort by local cell id (dead last), then P2G pass 1 on the padded grid
    sorted_, geoms, segs, grids = [], [], [], []
    for a, st in enumerate(slabs):
        x0 = a * loc
        g0 = _local_geometry(st.pos, st.mass > 0, config, x0)
        order = torch.argsort(g0.flat_base, stable=True)
        st = st.permute(order)
        lcid = g0.flat_base[order]
        cells = torch.arange(cfg_local.num_cells + 1, dtype=lcid.dtype, device=lcid.device)
        seg = torch.searchsorted(lcid, cells).to(torch.int32)
        geom = _local_geometry(st.pos, st.mass > 0, config, x0)
        sorted_.append(st)
        geoms.append(geom)
        segs.append(seg)
        grids.append(binned.p2g_pass1(st, geom, seg, cfg_local))

    grids = _halo_fill(_halo_reduce(grids, loc, pc), loc, pc, mom_too=False)
    grids = [binned.p2g_pass2(st, geom, seg, g, cfg_local, fp)
             for st, geom, seg, g in zip(sorted_, geoms, segs, grids)]
    grids = _halo_reduce(grids, loc, pc, mom_only=True)
    grids = [_update_grid_local(g, cfg_local, config, fp, a * loc) for a, g in enumerate(grids)]
    grids = _halo_fill(grids, loc, pc, mom_too=True)

    stayed, lefts, rights = [], [], []
    for a, (st, geom, seg, g) in enumerate(zip(sorted_, geoms, segs, grids)):
        x0 = a * loc
        alive = st.mass > 0
        # gather on the local padded grid, the tail in global coordinates
        vel_g, C_g = reference.g2p_gather(g, geom, cfg_local)
        new = reference.g2p_tail(st, vel_g, C_g, config, fp, interactions)
        # dead slots stay parked inside the slab, so their cell id stays local
        park = torch.tensor([x0 + loc / 2.0] + [r / 2.0 for r in config.grid_res[1:]],
                            dtype=new.pos.dtype, device=new.pos.device)[:, None]
        st = SimState(pos=torch.where(alive, new.pos, park), vel=torch.where(alive, new.vel, 0.0),
                      C=torch.where(alive, new.C, 0.0), mass=st.mass, ids=st.ids)
        # leftward movers sit at the front of the sorted order, rightward
        # ones at the live tail: a window of p_cap each crosses over; the
        # rest stay alive and try again next substep
        new_bx = torch.clamp(torch.floor(st.pos[0]).to(torch.int32), 1, config.grid_res[0] - 2)
        go_left = alive & (new_bx < x0)
        go_right = alive & (new_bx >= x0 + loc)
        n_live = seg[-1].long()
        r_start = torch.clamp_min(n_live - p_cap, 0)
        lefts.append(_window(st, torch.zeros_like(r_start), go_left, p_cap))
        rights.append(_window(st, r_start, go_right, p_cap))
        i = torch.arange(st.num_particles, device=alive.device)
        exported = (go_left & (i < p_cap)) | (go_right & (i >= r_start) & (i < n_live))
        stayed.append(SimState(pos=st.pos, vel=st.vel, C=st.C,
                               mass=torch.where(exported, 0.0, st.mass), ids=st.ids))

    out = []
    for a, st in enumerate(stayed):
        dev = st.pos.device
        # received in the tail 2 * p_cap slots, which live particles never
        # reach (n_live <= n_cap - 2 * p_cap); the wrapped ends carry none
        from_left = _to(rights[(a - 1) % n], dev)
        from_right = _to(lefts[(a + 1) % n], dev)
        if a == 0:
            from_left.mass = torch.zeros_like(from_left.mass)
        if a == n - 1:
            from_right.mass = torch.zeros_like(from_right.mass)
        n_cap = st.num_particles
        st = _land(st, from_left, n_cap - 2 * p_cap)
        out.append(_land(st, from_right, n_cap - p_cap))
    return out


def make_sharded_step(config: SimConfig, sconf: ShardConfig, mesh: SlabMesh,
                      substeps: int | None = None):
    """The sharded frame step (state, fluid, interactions) -> state over a
    ShardedSimState: `substeps` (default config.substeps) sort-based
    substeps on the mesh's slabs."""
    if mesh.n != sconf.n_shards:
        raise ValueError(f"the mesh has {mesh.n} slabs, the shard config {sconf.n_shards}")
    nsub = substeps if substeps is not None else config.substeps

    def step(state: ShardedSimState, fp: FluidParams,
             interactions: Sequence[Interaction] = ()) -> ShardedSimState:
        slabs = state.slabs
        for _ in range(nsub):
            slabs = sharded_substep(slabs, config, sconf, fp, interactions)
        return ShardedSimState(slabs)

    return step


def shard_scene(scene, sconf: ShardConfig, mesh: SlabMesh) -> ShardedSimState:
    """A scene's particles distributed into each slab's fixed-capacity
    arrays (dead slots parked inside the slab), on the mesh's devices."""
    config = scene.config
    n = sconf.n_shards
    loc = config.grid_res[0] // n
    n_cap, p_cap = sconf.local_capacity, sconf.migration_capacity
    if n_cap <= 0 or p_cap < 0:
        raise ValueError("local_capacity must be positive and migration_capacity >= 0")
    st = scene.state
    pos, vel, C = (t.detach().cpu().float() for t in (st.pos, st.vel, st.C))
    mass, ids = st.mass.detach().cpu().float(), st.ids.detach().cpu()
    shard_of = torch.clamp(torch.floor(pos[0]).to(torch.int64) // loc, 0, n - 1)
    dim = config.dim
    slabs = []
    for s, dev in enumerate(mesh.devices):
        sel = torch.nonzero(shard_of == s).squeeze(1)
        cnt = int(sel.numel())
        if cnt > n_cap - 2 * p_cap:
            raise ValueError(f"shard {s}: {cnt} particles exceed capacity "
                             f"{n_cap} - 2*{p_cap}")
        g_pos = torch.zeros((dim, n_cap))
        g_pos[:, :cnt] = pos[:, sel]
        g_pos[0, cnt:] = (s + 0.5) * loc
        for a in range(1, dim):
            g_pos[a, cnt:] = config.grid_res[a] / 2.0
        g_vel = torch.zeros((dim, n_cap))
        g_vel[:, :cnt] = vel[:, sel]
        g_C = torch.zeros((dim, dim, n_cap))
        g_C[:, :, :cnt] = C[:, :, sel]
        g_mass = torch.zeros(n_cap)
        g_mass[:cnt] = mass[sel]
        g_ids = torch.full((n_cap,), -1, dtype=torch.int32)
        g_ids[:cnt] = ids[sel]
        slabs.append(_to(SimState(pos=g_pos, vel=g_vel, C=g_C, mass=g_mass, ids=g_ids), dev))
    return ShardedSimState(slabs)


def gather_live(state: ShardedSimState) -> SimState:
    """Every slab's live slots in one SimState on the first slab's device,
    in emission order (for analysis and comparison)."""
    dev = state.slabs[0].pos.device
    s = SimState(*(torch.cat([getattr(sl, f).to(dev) for sl in state.slabs], dim=-1)
                   for f in ("pos", "vel", "C", "mass", "ids")))
    return s.permute(torch.nonzero(s.mass > 0).squeeze(1)).by_id()


def demo_sharded_step(n_slabs: int, device="cuda") -> None:
    """One sort-based sharded substep of a tiny scene on n_slabs slabs of
    one device (domain.py:477-514): no particle lost or duplicated, ids
    equal to the binned engine's and pos within 2e-3."""
    from ..models.scenes import fluid_3d
    from ..ops.step import make_step

    mesh = SlabMesh.on(device, n_slabs)
    scene = fluid_3d(grid_res=16, box=8.0, spacing=1.0, device=device)
    config = scene.config.replace(substeps=1)
    sconf = ShardConfig(n_shards=n_slabs,
                        local_capacity=scene.state.num_particles + 2 * 96 + 64,
                        migration_capacity=96)
    out = make_sharded_step(config, sconf, mesh, substeps=1)(
        shard_scene(scene._replace(config=config), sconf, mesh), scene.fluid)
    live = gather_live(out)
    want = make_step(config, mode="binned", substeps=1)(scene.state, scene.fluid).by_id()
    if live.num_particles != scene.state.num_particles or not torch.equal(live.ids, want.ids):
        raise AssertionError(f"demo_sharded_step({n_slabs}): {live.num_particles} live of "
                             f"{scene.state.num_particles}, or ids out of order")
    err = float((live.pos - want.pos).abs().max())
    if not err <= 2e-3:
        raise AssertionError(f"demo_sharded_step({n_slabs}): max |pos - binned| {err}")
