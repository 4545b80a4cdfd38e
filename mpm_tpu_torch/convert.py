"""State and parameters carried across from the JAX package.

The JAX package's objects arrive as plain data: a SimConfig as a dict of
its fields, FluidParams as a dict of numpy arrays, and states as numpy
arrays (bfloat16 arrays included). The caller does the JAX -> numpy step,
so this module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.params import FluidParams, SimConfig
from .core.state import Grid, SimState
from .ops.bucketed import BucketState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_from_fields(fields: dict) -> SimConfig:
    """A SimConfig from the JAX SimConfig's fields. `dtype` may be a dtype
    object or its name; tuples may arrive as lists."""
    names = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {}
    for key, val in fields.items():
        if key not in names:
            raise ValueError(f"unknown SimConfig field {key!r}")
        if key == "dtype":
            val = _DTYPES[np.dtype(val).name]
        elif key in ("grid_res", "domain_res") and val is not None:
            val = tuple(int(v) for v in val)
        kw[key] = val
    return SimConfig(**kw)


def fluid_from_numpy(fields: dict) -> FluidParams:
    """FluidParams from a dict of the JAX FluidParams' numpy arrays."""
    names = [f.name for f in dataclasses.fields(FluidParams)]
    return FluidParams(**{
        n: torch.from_numpy(np.array(fields[n], dtype=np.float32)) for n in names})


def _tensor(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: exact through float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None:
        t = t.to(dtype)
    return t.contiguous().to(device)


def simstate_from_numpy(pos, vel, C, mass, ids, device) -> SimState:
    """A SimState from the JAX SimState's arrays (pos [D, N] ...)."""
    return SimState(pos=_tensor(pos, device), vel=_tensor(vel, device),
                    C=_tensor(C, device), mass=_tensor(mass, device),
                    ids=_tensor(ids, device, torch.int32))


def bucket_state_from_numpy(pos, vel, C, mass, ids, lost, cfl_clamped,
                            deferred, ceiling, device) -> BucketState:
    """A BucketState from the JAX BucketState's arrays and counters."""
    def counter(x):
        return _tensor(x, device, torch.int32).reshape(())

    return BucketState(
        pos=_tensor(pos, device), vel=_tensor(vel, device), C=_tensor(C, device),
        mass=_tensor(mass, device), ids=_tensor(ids, device, torch.int32),
        lost=counter(lost), cfl_clamped=counter(cfl_clamped),
        deferred=counter(deferred), ceiling=counter(ceiling))


def grid_from_numpy(mom, mass, device) -> Grid:
    """A Grid from the JAX Grid's arrays (mom [D, C], mass [C]), in their
    dtypes: float32, or int32 for a fixed-point grid."""
    return Grid(mom=_tensor(mom, device), mass=_tensor(mass, device))
