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

import contextlib
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
# registers, shared memory and spills per kernel. --fmad=false: every kernel
# rounds each multiply and add apart, as its plain version does, so the two
# agree bit for bit and a trajectory does not hang on where nvcc fuses.
# Kernel F's and the 2D kernels' positions are held to atol 1e-6, less than
# one float32 ulp above 16 cells; kernel X (and F's emission) must break
# depth ties as the plain version does; kernel BL's filter size is a ceil of
# a quotient; and kernel P, fused, moves the 1M pool's trajectory in the
# last bits, enough to fail the 1080p render's band certificate (PERF.md).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

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


def _digest(src: Path, flags: list[str]) -> str:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_digest(src, NVCC_FLAGS)}.so"


def build_all(names) -> None:
    """Build the missing libraries of `names`, one nvcc each, all started
    together; raise with nvcc's output if any fails."""
    jobs = []
    for name in names:
        so = _so_path(name)
        if name in _libs or so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_so_path(name)))
    return _libs[name]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as its raw handle (without the
    Stream object that torch.cuda.current_stream builds at each call)."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(idx))


def on_device(device):
    """A context that makes `device` current for a launch: none when it is
    current already."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
