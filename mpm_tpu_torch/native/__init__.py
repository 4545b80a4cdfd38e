"""The native frame-I/O library (frameio.cpp), loaded with ctypes: PNG
encoding, the u8 tonemap and raw float blobs. Port of ``mpm_tpu.native``,
with the same functions, signatures and return conventions: each returns
None (False for `write_blob`) where the library is unavailable, and the
callers (render/image.py) then take the standard library.

The library is built at first use with g++ and the JAX package's flags
(mpm_tpu/native/Makefile), so the two libraries write the same bytes on
one machine, into mpm_tpu_torch/_build/libframeio-<hash>.so, the hash
taken over the source, the flags and the host CPU's instruction-set
extensions (the flags line of /proc/cpuinfo, which -march=native follows):
an edited source is rebuilt, an unchanged one loaded as it is, and a
library built on one host is never loaded on another whose CPU may lack
its instructions. A failed build leaves g++'s output in `build_error`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "frameio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-std=c++17"]  # mpm_tpu/native/Makefile's

_lib = None
_tried = False
_lock = threading.Lock()
build_error: str | None = None  # g++'s output (or the load error) of a failed build


@functools.cache
def host_isa() -> str:
    """The host CPU's instruction-set extensions, which -march=native builds
    for: the flags line of /proc/cpuinfo (Features on Arm), else the
    machine's name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.strip()
    except OSError:
        pass
    return platform.machine()


def lib_path() -> Path:
    """Where the library of this source, these flags and this host's CPU is
    built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS]).encode())
    h.update(host_isa().encode())
    return BUILD_DIR / f"libframeio-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """g++ into a file of this process, then renamed into place (other
    processes may build the same library at once)."""
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-shared", "-o", str(tmp), str(SRC), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"{' '.join(cmd)}: {e}"
        return
    if proc.returncode != 0:
        build_error = f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return
    os.replace(tmp, so)


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not so.exists():
            _build(so)
            if not so.exists():
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            build_error = f"loading {so}: {e}"
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.frameio_encode_png.restype = ctypes.c_int
        lib.frameio_encode_png.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
        lib.frameio_free.argtypes = [u8p]
        lib.frameio_tonemap_u8.argtypes = [f32p, ctypes.c_int, u8p]
        lib.frameio_write_blob.restype = ctypes.c_int
        lib.frameio_write_blob.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
        lib.frameio_read_blob.restype = ctypes.c_int
        lib.frameio_read_blob.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def encode_png(img_u8: np.ndarray, compress_level: int = 1) -> bytes | None:
    """RGB8 [H, W, 3] -> PNG bytes, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img_u8.shape[:2]
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.frameio_encode_png(img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
                                compress_level, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.frameio_free(out)


def tonemap_u8(img_f32: np.ndarray) -> np.ndarray | None:
    """float32 linear light -> u8 (gamma 2.2, clamped to [0, 1]), or None."""
    lib = _load()
    if lib is None:
        return None
    img_f32 = np.ascontiguousarray(img_f32, np.float32)
    out = np.empty(img_f32.shape, np.uint8)
    lib.frameio_tonemap_u8(img_f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           img_f32.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def write_blob(path: str, arr: np.ndarray) -> bool:
    """A float32 blob (the 'MPMT' magic, an int64 count, the data)."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr, np.float32)
    rc = lib.frameio_write_blob(path.encode(),
                                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size)
    return rc == 0


def read_blob(path: str, shape, dtype=np.float32) -> np.ndarray | None:
    """The float32 blob at `path` as an array of `shape`, or None (no
    library, or a file of another magic or count)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(shape, np.float32)
    rc = lib.frameio_read_blob(path.encode(),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    return out if rc == 0 else None
