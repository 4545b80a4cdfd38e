"""Elementwise math that rounds as IEEE float32 does on every device."""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of `x`, in `x`'s dtype.

    PyTorch's vectorised CPU square root is not correctly rounded: torch
    2.13's AVX512 kernel differs from numpy's IEEE `np.sqrt` on 820,462 of
    2^22 seeded float32 values (tensors of 7 or more elements; a single
    element is exact), and its float64 square root on 54,583 of them. The
    float64 result's error is far below half a float32 ulp, so rounding it
    to float32 gives the IEEE float32 root: equal to numpy on all 2^22
    values. On the card `torch.sqrt` is already IEEE-rounded (as is the
    kernels' `sqrtf`, built without fast math), so a CUDA tensor takes it
    as it is. This is a difference of numerics, not of device: both give
    the same bits."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def pow_rn(x: torch.Tensor, p) -> torch.Tensor:
    """`x ** p` for a float exponent `p` (a Python float or a 0-d tensor),
    correctly rounded to `x`'s dtype on the CPU.

    PyTorch's vectorised CPU power is not correctly rounded: torch 2.13's
    float32 `x ** 7.0` differs from numpy's float64 power rounded to
    float32 on 18,705 of 2^20 seeded values in [0.5, 2). The float64 power
    rounded to float32 equals numpy on every tested value
    (tests/test_torch_numerics.py), so a CPU tensor takes it. On the card
    `torch.pow` stays as it is: the kernels and the plain versions both
    call CUDA's `powf` and agree bit for bit."""
    if x.device.type == "cpu":
        pd = p.double() if isinstance(p, torch.Tensor) else float(p)
        return torch.pow(x.double(), pd).to(x.dtype)
    return torch.pow(x, p)
