"""The benchmark's yardstick: the parts of the program's utils/roofline.py
that the metrics read (kernels P and F and the peaks), copied when the
benchmark was defined, so that a change to the program cannot move it. A
metric of another kernel copies that kernel's arithmetic beside these.

The least time an NVIDIA H100 could take for each kernel's work: the
largest of the bytes the function must move over the card's memory rate,
the float32 operations it must do over the card's rate outside the tensor
cores (NVIDIA's data sheet, SXM part: 3.35 TB/s, 67 TFLOP/s; both assume
the full 700 W power limit) and, where it takes exponentials, those over
the special-function units' rate: 132 SMs x 16 a clock x 1.98 GHz (the
SXM part's largest SM clock) = 4.18e12 a second.

Both count what the function needs on the inputs of the call that is
timed, not what the kernel does. Bytes: the mass of every slot (it says
which slots are occupied), the other inputs of the occupied slots only
(an empty slot's output is fixed), each read once, and every output
written once, whatever the kernel reads again from the caches. Operations
are counted from the code per occupied slot, with each
slot's axis and tap weights counted once however many passes use them: a
multiply, an add, a compare-and-select, a divide, a square root or an
exponential each count one.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def bound_ms(nbytes: float, flops: float, sfu_ops: float = 0) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which bounds it); the
    operations' time is the larger of the float32 operations' and the
    special-function operations' (`sfu_ops`, counted among `flops` too)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _slot_bytes(n_slots: int, *ts: torch.Tensor) -> int:
    """Bytes of `n_slots` slots of the [..., K, C] tensors `ts`."""
    return sum(n_slots * t.numel() // (t.shape[-2] * t.shape[-1]) * t.element_size()
               for t in ts)


def _occupied(state) -> int:
    return int((state.mass > 0).sum())


def _occupied_cells(state) -> int:
    return int((state.mass > 0).any(dim=0).sum())


# Operations per occupied slot, from the kernels' code, for D axes and
# T = 3^D taps:
def _weight_ops(dim: int) -> int:
    """The offsets from the cell (D), the axis weights (8 an axis), the tap
    offsets (3 an axis) and the T tap weights (D - 1 each): once a slot."""
    return 12 * dim + 3**dim * (dim - 1)


def _p2g1_ops(dim: int) -> int:
    """Pass 1: 2D^2 + 2D + 2 a tap."""
    return 3**dim * (2 * dim * dim + 2 * dim + 2)


def _coef_ops(dim: int) -> int:
    """The density gather (2 a tap), the EOS and force coefficients (15)."""
    return 3**dim * 2 + 15


def _p2g2_ops(dim: int, legacy_strain: bool) -> int:
    """Pass 2: 4D^2 + 4D a tap, or with the legacy strain 2D^2 + 4D a tap
    and D^2 + D to build it."""
    if legacy_strain:
        return (2 * dim * dim + 4 * dim) * 3**dim + dim * dim + dim
    return (4 * dim * dim + 4 * dim) * 3**dim


def _p2g_ops(dim: int, legacy_strain: bool) -> int:
    return _p2g1_ops(dim) + _coef_ops(dim) + _p2g2_ops(dim, legacy_strain)


def _encode_ops(dim: int) -> int:
    """A fixed-point grid: each slot's tap contributions encoded (a
    multiply and a truncation each), D + 1 in pass 1 and D in pass 2."""
    return 3**dim * (2 * dim + 1) * 2


def _g2p_ops(dim: int, n_inter: int) -> int:
    """The gather (2D^2 + 2D a tap), C = 4B, advect, clamp, wall springs
    and the CFL clamp (D^2 + 17D), each interaction (4D + 8)."""
    return 3**dim * (2 * dim * dim + 2 * dim) + dim * dim + 17 * dim + n_inter * (4 * dim + 8)


def _migrate_ops(dim: int) -> int:
    """Each axis phase: floor, subtract and clamp of the axis delta, in the
    reject and again in the select (8)."""
    return 8 * dim


SPLAT_OPS = 30  # a slot's view transform (18), projection and depth test


def p2g_update_work(state, config) -> tuple[int, int]:
    """(bytes, operations) of kernel P: mass, and pos, vel and C of the
    occupied slots in; grid velocity and mass out. The grid update counts
    4D operations a cell that holds a slot."""
    n, c, d = _occupied(state), config.num_cells, config.dim
    nbytes = _nbytes(state.mass) + _slot_bytes(n, state.pos, state.vel, state.C) \
        + 4 * c * (d + 1)
    ops = n * (_weight_ops(d) + _p2g_ops(d, config.legacy_strain)) \
        + _occupied_cells(state) * 4 * d
    if config.fixed_point:  # int32 grid, 4 B a value as float32; the codings
        # add the encodes, a decode of each cell's mass and momentum for
        # the update and of its mass for the density, and the re-encode
        ops += n * _encode_ops(d) + _occupied_cells(state) * (3 * d + 2)
    return nbytes, ops


def g2p_migrate_work(state, config, n_inter: int = 0, emit: bool = False) -> tuple[int, int]:
    """(bytes, operations) of kernel F: mass, and pos and ids of the
    occupied slots and the grid velocity of their cells in (the input vel
    and C are not read); the state out, and with `emit` the [5, C] splats."""
    n, c, d = _occupied(state), config.num_cells, config.dim
    nbytes = (_nbytes(state.mass) + _slot_bytes(n, state.pos, state.ids)
              + 4 * d * _occupied_cells(state)
              + _nbytes(state.pos, state.vel, state.C, state.mass, state.ids)
              + (20 * c if emit else 0))
    ops = _weight_ops(d) + _g2p_ops(d, n_inter) + _migrate_ops(d) + (SPLAT_OPS if emit else 0)
    # a fixed-point grid velocity (int32, 4 B as float32): one decode a
    # component of each occupied cell
    return nbytes, n * ops + (d * _occupied_cells(state) if config.fixed_point else 0)
