"""The JAX package's engines run in a subprocess without fused multiply-adds
(XLA_FLAGS=--xla_cpu_max_isa=AVX, as tests/torch_xla_ref.py does), for the
port's bit-exact comparisons on the CPU of the oracle, the binned engine,
2D bf16 and fixed-point storage and many spheres.

A case names a scene of mpm_tpu.models.scenes (with keyword arguments), a
config override, an engine ("reference", "binned", "bucketed" or
"sharded"), a number of substeps and a list of spheres [n, D + 4] (centre,
radius, strength, inv_falloff, active). Linear engines take the scene's own
state and return it by id after each recorded substep; "bucketed" takes the
bucket state given as numpy arrays and returns it. "sharded" is the
sort-based sharded step (mpm_tpu.parallel.domain) on `n_shards` forced host
devices with `local_capacity` and `migration_capacity`, `substeps` calls of
`per_call` substeps each, returning gather_live's state. bf16 fields travel
as float32.

Run as a script it reads the cases from a JSON file and the states from an
npz file, and writes the results to another npz:
`python torch_jax_cases.py SPEC.json IN.npz OUT.npz`."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
LINEAR = ("pos", "vel", "C", "mass", "ids")
BUCKET = ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling")


def run_cases(cases: dict, states: dict | None = None) -> dict:
    """{case: {field or "field@substep": array}} for {case: spec}; `states`
    gives the bucketed cases' initial states ({case: {field: array}})."""
    with tempfile.TemporaryDirectory() as tmp:
        spec, src, dst = Path(tmp, "spec.json"), Path(tmp, "in.npz"), Path(tmp, "out.npz")
        spec.write_text(json.dumps(cases))
        np.savez(src, **{f"{c}.{f}": a for c, st in (states or {}).items()
                         for f, a in st.items()})
        flags = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX"
        shards = max((c.get("n_shards", 1) for c in cases.values()), default=1)
        if shards > 1:
            flags += f" --xla_force_host_platform_device_count={shards}"
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip(),
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(spec),
                               str(src), str(dst)], env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=240)
        if proc.returncode != 0:
            raise RuntimeError(f"the JAX reference failed:\n{proc.stderr[-4000:]}")
        out: dict = {c: {} for c in cases}
        with np.load(dst) as z:
            for key in z.files:
                c, _, f = key.partition(".")
                out[c][f] = z[key]
        return out


def _main(argv) -> None:
    import jax
    import jax.numpy as jnp

    from mpm_tpu.models import scenes
    from mpm_tpu.ops import binned, bucketed, reference
    from mpm_tpu.ops.interact import Interaction

    spec_path, src, dst = argv
    cases = json.loads(Path(spec_path).read_text())
    out = {}
    with np.load(src) as z:
        for case, spec in cases.items():
            sc = scenes.SCENES[spec["scene"]](**spec.get("scene_kw", {}))
            cfg = sc.config.replace(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in spec.get("config", {}).items()})
            inter = tuple(Interaction(center=jnp.asarray(r[:-4], jnp.float32),
                                      radius=jnp.float32(r[-4]), strength=jnp.float32(r[-3]),
                                      inv_falloff=jnp.float32(r[-2]), active=jnp.float32(r[-1]))
                          for r in spec.get("spheres", []))
            engine, n = spec["engine"], spec["substeps"]
            record = set(spec.get("record", [n]))
            if engine == "sharded":
                live = _sharded(scenes.Scene(sc.name, cfg, sc.fluid, sc.state), spec)
                for f in LINEAR:
                    out[f"{case}.{f}"] = np.asarray(getattr(live, f))
                continue
            if engine == "bucketed":
                vc = jnp.bfloat16 if cfg.storage_dtype == "bfloat16" else jnp.float32
                s = bucketed.BucketState(*(
                    jnp.asarray(z[f"{case}.{f}"]).astype(vc) if f in ("vel", "C")
                    else jnp.asarray(z[f"{case}.{f}"]) for f in BUCKET))
                fn, fields = bucketed.substep, BUCKET
            else:
                s = sc.state
                fn = reference.substep if engine == "reference" else binned.substep
                fields = LINEAR
            # the spheres and the fluid as arguments, as make_step takes them:
            # XLA folds constants into other roundings
            step = jax.jit(lambda s, fp, it, cfg=cfg, fn=fn: fn(s, cfg, fp, it))
            for i in range(1, n + 1):
                s = step(s, sc.fluid, inter)
                if i in record:
                    r = s if engine == "bucketed" else s.by_id()
                    for f in fields:
                        a = getattr(r, f)
                        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
                        out[f"{case}.{f}" if i == n else f"{case}.{f}@{i}"] = a
    np.savez(dst, **out)


def _sharded(sc, spec):
    """gather_live of `substeps` calls of JAX's make_sharded_step."""
    import jax
    from jax.sharding import Mesh

    from mpm_tpu.parallel import domain

    n_sh = spec["n_shards"]
    mesh = Mesh(np.array(jax.devices()[:n_sh]), ("x",))
    sconf = domain.ShardConfig(n_shards=n_sh, local_capacity=spec["local_capacity"],
                               migration_capacity=spec["migration_capacity"])
    state = domain.shard_scene(sc, sconf, mesh)
    step = domain.make_sharded_step(sc.config, sconf, mesh, substeps=spec["per_call"])
    for _ in range(spec["substeps"]):
        state = step(state, sc.fluid, ())
    return domain.gather_live(state)


if __name__ == "__main__":
    _main(sys.argv[1:])
