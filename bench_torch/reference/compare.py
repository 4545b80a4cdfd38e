"""The numbers that decide `correct`, each computed from two answers."""

from __future__ import annotations

import torch


def by_id(x: torch.Tensor, ids: torch.Tensor, n: int):
    """([D, n] float32 values of the [..., K, C] field `x` in id order (D
    the product of its leading axes), NaN where an id is missing; the count
    of ids missing, repeated or out of range)."""
    flat = ids.reshape(-1)
    live = flat >= 0
    idx = flat[live].long()
    bad = int(((idx < 0) | (idx >= n)).sum())
    idx = idx.clamp(0, n - 1)
    counts = torch.bincount(idx, minlength=n)
    bad += int((counts != 1).sum())
    d = x[..., 0, 0].numel()
    out = torch.full((d, n), float("nan"), dtype=torch.float32, device=x.device)
    out[:, idx] = x.reshape(d, -1)[:, live].float()
    return out, bad


def gap(a, a_ids, b, b_ids, n: int) -> float:
    """The widest gap between one particle's value of a field (position,
    velocity or affine matrix) in answer a and in answer b, over every
    component and the ids both hold (infinite where they share none).
    Whether an answer holds every id once is checked apart."""
    a, _ = by_id(a, a_ids, n)
    b, _ = by_id(b, b_ids, n)
    d = (a - b).abs()
    both = ~(torch.isnan(a) | torch.isnan(b)).any(dim=0)
    if not bool(both.any()):
        return float("inf")
    return float(torch.nan_to_num(d[:, both], nan=float("inf")).max())


def state_gaps(a, b, n: int) -> dict:
    """pos_gap (cells), vel_gap (cells a unit of time) and C_gap (the
    affine matrix, a unit of time) between two states, by id."""
    return {"pos_gap": gap(a.pos, a.ids, b.pos, b.ids, n),
            "vel_gap": gap(a.vel, a.ids, b.vel, b.ids, n),
            "C_gap": gap(a.C, a.ids, b.C, b.ids, n)}


def px_off_pct(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share, in %, of the pixels of two u8 frames [H, W, 3] whose
    channels differ by more than 1 somewhere."""
    if a.shape != b.shape:
        return 100.0
    diff = (a.to(torch.int16) - b.to(a.device).to(torch.int16)).abs().amax(dim=-1)
    return 100.0 * float((diff > 1).sum()) / diff.numel()
