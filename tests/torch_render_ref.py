"""The JAX package's render functions run in a subprocess under
XLA_FLAGS=--xla_cpu_max_isa=AVX, for the port's bit-exact comparisons of
the render path on the CPU (tests/torch_xla_ref.py explains why: XLA on the
CPU contracts `a * b + c` to fused multiply-adds unless the process starts
without FMA instructions, and tests/conftest.py starts XLA first).

XLA also computes a division by a constant, such as the dilation's
`depth / focal`, as a multiply by the float32 reciprocal, with or without
the flag. The callers use a camera whose focal length is 64 (128 pixels
high, a 90 degree field of view), where the two agree.

`xla_render(inputs)` sends numpy arrays by name and returns the results by
name: for each "<case>.d" (raw z-buffer) and "<case>.k" (velocity key) the
dilation with velocity and normals, "<case>.depth", ".velocity", ".sx" and
".sy" at radius inputs["R"]; for "t" (a thickness deposit) the Gaussian
blurs "blur<r>" of radius 1 and 6. Run as a script: `python
torch_render_ref.py IN.npz OUT.npz`."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CAMERA = dict(width=128, height=128, fov_y_deg=90.0)  # focal length 64


def xla_render(inputs: dict) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp, "in.npz"), Path(tmp, "out.npz")
        np.savez(src, **inputs)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip(),
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(src), str(dst)],
                              env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"the XLA render reference failed:\n{proc.stderr[-4000:]}")
        with np.load(dst) as out:
            return {k: out[k] for k in out.files}


def _main(src: str, dst: str) -> None:
    import jax

    from mpm_tpu.render import Camera
    from mpm_tpu.render import splat, ssfr

    cam = Camera(**CAMERA)
    out = {}
    with np.load(src) as z:
        r = int(z["R"])
        dilate = jax.jit(lambda d, k: splat.buffers_from_zbuffer(d, k, cam, 1.0, r,
                                                                 with_normals=True))
        for case in sorted({k.split(".")[0] for k in z.files if k.endswith(".d")}):
            b = dilate(z[f"{case}.d"], z[f"{case}.k"])
            for f in ("depth", "velocity", "sx", "sy"):
                out[f"{case}.{f}"] = np.asarray(getattr(b, f))
        if "t" in z.files:
            for radius in (1, 6):
                out[f"blur{radius}"] = np.asarray(
                    jax.jit(lambda x, radius=radius: ssfr.gaussian_blur(x, radius))(z["t"]))
    np.savez(dst, **out)


if __name__ == "__main__":
    _main(*sys.argv[1:])
