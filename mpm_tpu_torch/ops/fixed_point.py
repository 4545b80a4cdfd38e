"""int32 fixed-point grid accumulation (port of ``mpm_tpu.ops.fixed_point``).

The reference accumulates grid mass/momentum as int32 with multiplier 1e7 so
atomic adds commute exactly (p2g_1.glsl:34-37). Encoding truncates toward
zero like the reference's `int(x * mult)` cast.
"""

from __future__ import annotations

import torch


def encode(x: torch.Tensor, mult: float) -> torch.Tensor:
    return torch.trunc(x * mult).to(torch.int32)


def decode(x: torch.Tensor, mult: float, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    # the divisor lies on x's device: PyTorch computes a CUDA tensor over a
    # CPU scalar as a multiply by the reciprocal, which is not x / mult
    return x.to(dtype) / torch.tensor(mult, dtype=dtype, device=x.device)
