"""Constitutive model: weakly-compressible EOS (port of ``mpm_tpu.ops.stress``).

    volume   = m / rho
    pressure = max(floor, k * ((rho / rho0)^gamma - 1))      (p2g_2.glsl:94)
    sigma    = -p I + mu (C + C^T)
    eq16     = -4 dt V sigma
"""

from __future__ import annotations

import torch

from ..core.params import FluidParams
from .fmath import pow_rn


def pow_static(x: torch.Tensor, p: float) -> torch.Tensor:
    """x ** p for a static exponent. Integer powers unroll into multiplies by
    binary exponentiation, in the JAX package's multiply order (the CUDA
    kernel repeats it, so all three round alike)."""
    if float(p).is_integer() and 0 < p <= 32:
        n = int(p)
        result = None
        base = x
        while n:
            if n & 1:
                result = base if result is None else result * base
            n >>= 1
            if n:
                base = base * base
        return result
    return pow_rn(x, p)


def eos_pressure(density: torch.Tensor, fp: FluidParams,
                 power_static: float = 0.0) -> torch.Tensor:
    """Tait/Murnaghan pressure. `power_static` (SimConfig.eos_power_static)
    fixes the exponent; 0.0 uses fp.eos_power."""
    # divide by a tensor on density's device: PyTorch computes a CUDA tensor
    # divided by a CPU scalar as a multiply by the reciprocal, while the
    # kernels (and the JAX package) divide
    ratio = density / fp.rest_density.to(density.device)
    rp = pow_static(ratio, power_static) if power_static else pow_rn(ratio, fp.eos_power)
    return torch.maximum(fp.pressure_floor.to(ratio.device),
                         fp.eos_stiffness * (rp - 1.0))
