"""Step-level failure detection with last-good-state rollback (port of
``mpm_tpu.utils.guard``).

The reference has no failure handling (SURVEY.md §5): its clamps keep the
simulation running even when it explodes. `GuardedStep` checks the state
for non-finite values and rolls back to the last VERIFIED snapshot, with a
smaller dt:

- snapshots are taken every `snapshot_every` frames (a clone of every
  tensor of the state, or of every slab of a sharded state); a rollback
  loses at most that many frames of progress;
- the check is one on-device reduce every `check_every` frames (pos and
  vel finite), its flag copied with `non_blocking=True` into pinned host
  memory behind a recorded CUDA event and read once `event.query()` says
  it has landed, so the loop never waits for the card; on the CPU, and
  with `sync=True`, a check blocks;
- a snapshot becomes the rollback target only once every check at or
  before its frame has resolved finite (double-buffered promotion), so a
  late-detected blow-up never rolls back INTO a poisoned state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# The fields the check reads. The port's engines clamp a NaN position into
# the domain as the kernels' fminf/fmaxf do (ops/bucketed._clip), so the
# NaN of a blow-up lives on in vel (and C) and pos alone would miss it.
CHECKED = ("pos", "vel")


def _tensors(state) -> list[torch.Tensor]:
    """The tensors of a state: a BucketState or SimState, or every slab of
    a sharded state."""
    if hasattr(state, "slabs"):
        return [t for s in state.slabs for t in _tensors(s)]
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def state_is_finite(state) -> bool:
    """Host-side finiteness check of every float tensor (blocking; for tests
    and debugging: the guard's hot path uses an async flag)."""
    return all(bool(torch.isfinite(t).all()) for t in _tensors(state) if t.is_floating_point())


def _copy(state):
    """A clone of every tensor of the state."""
    if hasattr(state, "slabs"):
        return dataclasses.replace(state, slabs=[_copy(s) for s in state.slabs])
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


class _Check:
    """One finiteness flag on its way to the host: the 0-d bool result of
    the reduce, copied into pinned memory behind an event on a card."""

    def __init__(self, ok: torch.Tensor):
        self.event = None
        if ok.device.type == "cuda":
            self.flag = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.flag.copy_(ok, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(ok.device))
        else:
            self.flag = ok

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def value(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(self.flag)


class GuardedStep:
    """Wraps a step fn (state, fluid, interactions) -> state with NaN/blow-up
    detection and verified-snapshot rollback.

    On a detected failure it returns the last VERIFIED snapshot, scales dt
    by `dt_backoff` for every later call, and counts the event; past
    `max_failures` it raises. Detection can lag the failing frame by up to
    `check_every` frames (the async flags); the promotion protocol keeps
    the restored snapshot older than the first unverified frame, so the
    rollback target is always finite.

    The JAX package checks `pos` alone: there a NaN position stays NaN
    (its clip keeps a NaN). In the port it does not (CHECKED), so the port
    checks vel as well.

    Its cost: a snapshot clones the state once per `snapshot_every` calls
    (the CLI: 32); a check reduces pos and vel once per `check_every` (the
    CLI: 8).

    `failures`, `current_dt_scale` and `frames_lost` are diagnostics."""

    def __init__(self, step: Callable, check_every: int = 4,
                 dt_backoff: float = 0.5, max_failures: int = 8,
                 snapshot_every: int = 16, sync: bool = False):
        self._step = step
        self.sync = sync
        self.check_every = max(1, check_every)
        self.snapshot_every = max(1, snapshot_every)
        self.dt_backoff = dt_backoff
        self.max_failures = max_failures
        self.failures = 0
        self.frames_lost = 0
        self.current_dt_scale = 1.0
        self._good = None        # (frame, state): fully verified
        self._candidate = None   # (frame, state): newer, awaiting checks
        self._pending = []       # [(frame, _Check)] oldest first
        self._verified = -1      # highest frame with all checks <= it ok
        self._count = 0

    @staticmethod
    def _flag(state) -> torch.Tensor:
        """0-d bool on the (first slab's) device: every CHECKED field of
        every slab finite."""
        slabs = state.slabs if hasattr(state, "slabs") else [state]
        dev = slabs[0].pos.device
        return torch.stack([torch.isfinite(getattr(s, f)).all().to(dev)
                            for s in slabs for f in CHECKED]).all()

    def _check(self, frame: int, state) -> None:
        self._pending.append((frame, _Check(self._flag(state))))

    def _drain(self, block: bool) -> bool:
        """Consume resolved checks oldest-first; returns False on the first
        non-finite result (leaving self._verified at the last good frame)."""
        while self._pending:
            frame, chk = self._pending[0]
            if not block and not chk.ready():
                break
            self._pending.pop(0)
            if not chk.value():
                return False
            self._verified = frame
            self._promote()
        return True

    def _promote(self):
        if self._candidate is not None and self._candidate[0] <= self._verified:
            self._good = self._candidate
            self._candidate = None

    def _fail(self, at_frame: int):
        self.failures += 1
        if self.failures > self.max_failures:
            raise RuntimeError(f"simulation diverged {self.failures} times; giving up")
        self.current_dt_scale *= self.dt_backoff
        self._pending.clear()
        self._candidate = None  # may postdate the poison: discard
        frame, good = self._good
        self.frames_lost += at_frame - frame
        self._count = frame
        self._verified = frame
        self._good = (frame, _copy(good))
        return good

    def __call__(self, state, fluid, interactions=()):
        if self._good is None:
            self._good = (self._count, _copy(state))
            self._verified = self._count
        fluid_eff = fluid if self.current_dt_scale == 1.0 else dataclasses.replace(
            fluid, dt=torch.tensor(float(fluid.dt) * self.current_dt_scale,
                                   dtype=torch.float32))
        out = self._step(state, fluid_eff, interactions)
        self._count += 1
        polled = False
        if self._count % self.check_every == 0:
            self._check(self._count, out)
            # drain at check boundaries only (or when sync): the detection
            # lag grows by at most check_every calls, which the promotion
            # protocol tolerates
            polled = True
            if not self._drain(block=self.sync):
                return self._fail(self._count)
        if self.sync and not polled and not self._drain(block=True):
            return self._fail(self._count)
        if self._count % self.snapshot_every == 0:
            # the new snapshot may postdate in-flight checks: hold it as the
            # candidate until every check <= its frame resolves finite, and
            # make sure a check covers this exact frame
            if not self._pending or self._pending[-1][0] < self._count:
                self._check(self._count, out)
            self._candidate = (self._count, _copy(out))
            self._promote()
        return out

    def flush(self) -> bool:
        """Block on every in-flight check. Call at the end of a run before
        trusting the final state. True iff no failure was pending; on False
        the rollback bookkeeping has run (failures/dt/frames_lost) and
        `last_good()` is the state to resume from."""
        if not self._drain(block=True):
            self._fail(self._count)
            return False
        self._promote()
        return True

    def last_good(self):
        """The newest fully verified snapshot (the resume point after a
        flush that returned False)."""
        return self._good[1]
