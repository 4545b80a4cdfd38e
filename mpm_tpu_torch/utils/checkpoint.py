"""Checkpoint / resume (port of ``mpm_tpu.utils.checkpoint``).

One compressed .npz a checkpoint, in the JAX package's layout, so each
package reads the other's files:

- `state_{i}`: the state's fields in dataclass order (BucketState: pos,
  vel, C, mass, ids, lost, cfl_clamped, deferred, ceiling; SimState: pos,
  vel, C, mass, ids), the order the JAX package's pytrees flatten in;
- `fluid_{name}`: each FluidParams field;
- `__meta__`: JSON bytes with `state_class`, `config` (the SimConfig's
  fields but `dtype`) and `extra`.

bfloat16 has no numpy dtype. The JAX package writes a bf16 array (the
pool's vel and C) as 2-byte void records (`|V2`); this module reads such
a leaf as bf16 bits and writes bf16 the same way.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core.params import FluidParams, SimConfig
from ..core.state import SimState
from ..ops.bucketed import BucketState

_BF16_RECORD = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _BF16_RECORD:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def save(path: str, state, fluid: FluidParams, config: SimConfig, extra: dict | None = None):
    """Save a BucketState or SimState (a sharded state is gathered first:
    parallel.domain.gather_bucket_state) with its fluid and config."""
    if hasattr(state, "slabs"):
        from ..parallel.domain import gather_bucket_state

        state = gather_bucket_state(state)
    leaves = [getattr(state, f.name) for f in dataclasses.fields(state)]
    arrays = {f"state_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays.update({f"fluid_{f.name}": _to_numpy(getattr(fluid, f.name))
                   for f in dataclasses.fields(fluid)})
    cfg = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)
           if f.name != "dtype"}
    meta = {
        "state_class": type(state).__name__,
        "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.items()},
        "extra": extra or {},
    }
    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **arrays)


def load(path: str, device="cpu"):
    """(state, fluid, config_dict, extra): the state's tensors on `device`,
    the fluid's float32 CPU tensors. The state class comes by name
    (SimState or BucketState); a BucketState written before the later
    counters existed gets them as zeros."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        n = len([k for k in data.files if k.startswith("state_")])
        leaves = [_from_numpy(data[f"state_{i}"], device) for i in range(n)]
        fluid = FluidParams(**{k[len("fluid_"):]: _from_numpy(data[k], "cpu")
                               for k in data.files if k.startswith("fluid_")})
    if meta["state_class"] == "SimState":
        state = SimState(*leaves)
    else:
        while len(leaves) < len(dataclasses.fields(BucketState)):
            leaves.append(torch.zeros((), dtype=torch.int32, device=device))
        state = BucketState(*leaves)
    return state, fluid, meta["config"], meta["extra"]
