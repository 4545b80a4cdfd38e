"""Kernel HF: the slab exchange's plane copies and fills in one hand-written
CUDA launch a slab (csrc/halo_fill.cu), beside its plain PyTorch version.

An exchange (parallel/domain.py) is a table of tensors, each [..., planes *
pc] with its rows evenly spaced and each row contiguous, and, slab by slab,
a list of segments (`Seg`): `planes` planes of a destination tensor of the
table written from as many planes of a source tensor, or filled with a
value (0, or -1 for the ids). `fill_plain` runs them as one copy_ or fill_
of a slice each. `Plan(table, segs, pc)` compiles them for the kernel once
for a table's layout, and `Plan.run(table, pc)` runs the exchange on any
table of that layout: a launch a slab on the card of its
destination tensors, which reads a neighbour slab's planes by device
pointer, on the same card or on a peer card. Where a pair of cards has no
peer access (torch.cuda.can_device_access_peer), the slab's segments from
that neighbour leave the launch and run as copy_ after it, into the same
planes (PyTorch's cross-card copy, with its own two-way ordering). The
ordering between cards is the kernel source's comment.

Counters, as the other kernels': `fill_launches` and `full_launches`, HF's
launches for in-place fills and for full exchanges (a plan made with
`full`), and `copies`, the segments run as copy_ for want of peer access.
The plain version counts nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from . import build

fill_launches = 0  # HF launches so far: in-place fills of halo and grid planes
full_launches = 0  # HF launches so far: full exchanges into new padded slabs
copies = 0  # segments so far run as copy_, where a pair of cards has no peer access


@dataclasses.dataclass(frozen=True)
class Seg:
    """Planes [dst_plane, dst_plane + planes) of table[dst] from planes
    [src_plane, ...) of table[src], or, with src None, filled with `fill`."""

    dst: int
    dst_plane: int
    src: int | None
    src_plane: int
    planes: int
    fill: int = 0


def _planes(t: torch.Tensor, first: int, planes: int, pc: int) -> torch.Tensor:
    return t[..., first * pc:(first + planes) * pc]


def fill_plain(table: Sequence[torch.Tensor], segs: Sequence[Sequence[Seg]], pc: int) -> None:
    """The plain version: each segment a copy_ (across devices, PyTorch's
    copy with its own ordering) or a fill_ of the destination's planes."""
    for slab in segs:
        for s in slab:
            dst = _planes(table[s.dst], s.dst_plane, s.planes, pc)
            if s.src is None:
                dst.fill_(s.fill)
            else:
                dst.copy_(_planes(table[s.src], s.src_plane, s.planes, pc))


def _row_stride(t: torch.Tensor) -> int | None:
    """Elements from one row of t (the leading axes flattened) to the next,
    or None where the rows are not evenly spaced or not contiguous."""
    if t.dim() == 1:
        return 0
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return None
    for i in range(t.dim() - 2):
        if t.shape[i] > 1 and t.stride(i) != t.stride(i + 1) * t.shape[i + 1]:
            return None
    return t.stride(-2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("halo_fill")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.halo_fill_plan_cols.argtypes = lib.halo_fill_max_segs.argtypes = []
    lib.halo_fill_plan_cols.restype = lib.halo_fill_max_segs.restype = ci
    lib.halo_event_new.argtypes = [ci]
    lib.halo_event_new.restype = vp
    lib.halo_enable_peer.argtypes = [ci, ci]
    lib.halo_enable_peer.restype = ci
    lib.halo_fill_run.argtypes = [ci] + [vp] * 8
    lib.halo_fill_run.restype = ci
    if (lib.halo_fill_plan_cols(), lib.halo_fill_max_segs()) != (PLAN_COLS, MAX_SEGS):
        raise RuntimeError("the plan's layout differs between csrc/halo_fill.cu and Python")
    return lib


PLAN_COLS = 9
MAX_SEGS = 16  # a launch's segments: a slab with more takes more launches


class Links:
    """How each slab of a list, on the cards `devs` (device indices, in
    slab order), reads its neighbours: peer[2a] (peer[2a + 1]) where slab a
    reads its left (right) neighbour on another card by device pointer,
    copied[2a] (...) where that pair of cards has no peer access; and the
    two events a slab orders its exchanges by."""

    def __init__(self, devs: tuple[int, ...]):
        n = len(devs)
        lib = _lib()
        self.devs = devs
        self.cards = [torch.device("cuda", d) for d in devs]
        self.peer, self.copied = [0] * (2 * n), [False] * (2 * n)
        for a in range(n):
            for side, b in ((0, a - 1), (1, a + 1)):
                if not 0 <= b < n or devs[b] == devs[a]:
                    continue
                if torch.cuda.can_device_access_peer(devs[a], devs[b]):
                    # PyTorch's own copy first, so that its caching allocator
                    # maps its blocks for the peer too, then the context's flag
                    torch.empty(1, device=devs[b]).copy_(torch.empty(1, device=devs[a]))
                    build.check_rc("halo_enable_peer", lib.halo_enable_peer(devs[a], devs[b]))
                    self.peer[2 * a + side] = 1
                else:
                    self.copied[2 * a + side] = True
        events = [lib.halo_event_new(d) for d in devs for _ in range(2)]
        if not all(events):
            raise RuntimeError("halo_event_new: no CUDA event")
        vp = ctypes.c_void_p
        self.c_dev = (ctypes.c_int * n)(*devs)
        self.c_peer = (ctypes.c_int * (2 * n))(*self.peer)
        self.c_ready = (vp * n)(*events[0::2])
        self.c_done = (vp * n)(*events[1::2])

    def streams(self):
        """The slabs' cards' current streams, as raw handles."""
        return (ctypes.c_void_p * len(self.devs))(*[build.stream_of(d) for d in self.cards])


@functools.cache
def links(devs: tuple[int, ...]) -> Links:
    return Links(devs)


class Plan:
    """The segments `segs` (slab by slab) over tables laid out as `table`,
    compiled for the kernel: byte offsets, row counts and strides, the
    segments that run as copy_ where a pair of cards has no peer access.
    Its launches count as full exchanges with `full`, else as fills."""

    def __init__(self, table: Sequence[torch.Tensor], segs: Sequence[Sequence[Seg]], pc: int,
                 full: bool = False):
        devs = []
        for slab in segs:
            d = {table[s.dst].device for s in slab}
            if len(d) != 1 or next(iter(d)).type != "cuda":
                raise ValueError("a slab's segments must write tensors of one CUDA device")
            devs.append(next(iter(d)).index)
        self.links = links(tuple(devs))
        rows, first, self.by_copy = [], [0], [[] for _ in segs]
        for a, slab in enumerate(segs):
            for s in slab:
                dst = table[s.dst]
                src = None if s.src is None else table[s.src]
                if src is not None and src.device != dst.device:
                    # the left neighbour's card, or else the right one's (where
                    # both neighbours share a card, the two sides read alike)
                    side = 0 if a > 0 and src.device.index == devs[a - 1] else 1
                    if self.links.copied[2 * a + side]:
                        self.by_copy[a].append(s)
                        continue
                rows.append(self._row(dst, src, s, pc))
            first.append(len(rows))
        self.n_slabs, self.full = len(segs), full
        self.launches = sum(-(-(j - i) // MAX_SEGS) for i, j in zip(first, first[1:]))
        self.c_plan = (ctypes.c_longlong * max(1, len(rows) * PLAN_COLS))(
            *[v for r in rows for v in r])
        self.c_first = (ctypes.c_int * len(first))(*first)
        self.size = len(table)

    @staticmethod
    def _row(dst, src, s: Seg, pc: int) -> list[int]:
        es = dst.element_size()
        n_rows = dst.numel() // dst.shape[-1]
        ds = _row_stride(dst)
        if ds is None:
            raise ValueError("a destination's rows must be evenly spaced and contiguous")
        if src is None:
            if s.fill not in (0, -1) or (s.fill == -1 and dst.is_floating_point()):
                raise ValueError("the kernel fills 0, or -1 in an integer tensor")
            si, so, ss, byte = -1, 0, 0, 0xFF if s.fill == -1 else 0
        else:
            st = _row_stride(src)
            if (st is None or src.dtype != dst.dtype
                    or src.numel() // src.shape[-1] != n_rows):
                raise ValueError("a source must match its destination's rows and dtype, "
                                 "its rows evenly spaced and contiguous")
            si, so, ss, byte = s.src, s.src_plane * pc * es, st * es, 0
        return [s.dst, s.dst_plane * pc * es, si, so, n_rows, s.planes * pc * es, ds * es, ss, byte]

    def run(self, table: Sequence[torch.Tensor], pc: int) -> None:
        """The exchange on `table` (laid out as the plan's): a launch a slab,
        then the copies that peer access could not take."""
        global fill_launches, full_launches, copies
        if len(table) != self.size:
            raise ValueError(f"the plan takes a table of {self.size} tensors, not {len(table)}")
        ln = self.links
        ptr = (ctypes.c_longlong * len(table))(*[t.data_ptr() for t in table])
        rc = _lib().halo_fill_run(self.n_slabs, ln.c_dev, ln.streams(), ln.c_ready, ln.c_done,
                                  ln.c_peer, self.c_plan, self.c_first, ptr)
        build.check_rc("halo_fill", rc)
        if self.full:
            full_launches += self.launches
        else:
            fill_launches += self.launches
        for segs in self.by_copy:
            if segs:
                fill_plain(table, [segs], pc)
                copies += len(segs)
