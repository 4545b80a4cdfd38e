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
# so a fused position update fails that bar at full width. Kernel X (and
# F's emission) must break depth ties as the plain version does, and kernel
# BL's filter size is a ceil of a quotient, so both round apart too.
KERNEL_FLAGS = {name: ["--fmad=false"]
                for name in ("g2p_migrate", "extract_cells", "blur_depth")}

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


def _so_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_digest(src, _flags(name))}.so"


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
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
