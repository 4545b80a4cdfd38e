"""Builds the CUDA kernels in mpm_tpu_torch/csrc with nvcc at first use and
loads them with ctypes.

Each `<name>.cu` becomes `_build/lib<name>-<hash>.so`, with the hash taken
over its source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The C entry points take
raw device pointers and the stream as `void*`; there is no PyTorch header in
the build, which keeps it to seconds. A failed build raises with nvcc's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# sm_90a: Hopper with its architecture-specific features. -Xptxas -v logs
# registers, shared memory and spills per kernel.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Kernel P keeps nvcc's fused multiply-adds: its grid velocity differs from
# the plain version's in the last bit, well inside its bar (1e-5 of max |v|),
# and fusing saves some 7% of its time on an H100 (PERF.md). Kernel F
# rounds every multiply and add apart, as the plain version does: its
# positions are held to atol 1e-6, less than one float32 ulp above 16 cells,
# so a fused position update fails that bar at full width.
KERNEL_FLAGS = {"g2p_migrate": ["--fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # kernels built by this process
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, [])


def _digest(src: Path, flags: list[str]) -> str:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built if needed."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    flags = _flags(name)
    so = BUILD_DIR / f"lib{name}-{_digest(src, flags)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = res.stdout + res.stderr
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
