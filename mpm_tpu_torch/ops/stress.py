"""Constitutive model: weakly-compressible EOS and viscous stress (port of
``mpm_tpu.ops.stress``).

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


def viscous_strain(C: torch.Tensor, legacy: bool = False) -> torch.Tensor:
    """Strain-rate proxy from the APIC matrix C [D, D, N]: C + C^T
    (p2g_2.glsl:103-105); `legacy` keeps the 2D serial variant's unscaled
    diagonal (MLSMPM2DFluid.cs:276-281): off-diagonals C_ij + C_ji,
    diagonal C_ii."""
    Ct = C.transpose(0, 1)
    full = C + Ct
    if not legacy:
        return full
    eye = torch.eye(C.shape[0], dtype=C.dtype, device=C.device)[:, :, None]
    return full - eye * Ct


def fused_force_term(density: torch.Tensor, mass: torch.Tensor, C: torch.Tensor,
                     fp: FluidParams, legacy_strain: bool = False) -> torch.Tensor:
    """The per-particle eq16 matrix [D, D, N] scattered in P2G pass 2
    (p2g_2.glsl:96-109), zero where the density is 0 (masked lanes stay
    finite). The exponent is fp.eos_power, as the JAX package's oracle
    takes it."""
    d = C.shape[0]
    dev = density.device
    safe_density = torch.where(density > 0, density, 1.0)
    volume = mass / safe_density
    pressure = eos_pressure(safe_density, fp)
    eye = torch.eye(d, dtype=C.dtype, device=dev)[:, :, None]
    stress = -pressure * eye + fp.dynamic_viscosity.to(dev) * viscous_strain(C, legacy_strain)
    eq16 = (-4.0 * fp.dt.to(dev)) * volume * stress
    return torch.where(density > 0, eq16, 0.0)
