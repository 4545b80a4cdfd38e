"""PNG export (port of ``mpm_tpu.render.image``): the native encoder of
mpm_tpu_torch/native where it builds, else the standard library (zlib +
struct)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Float [H, W, 3] in linear [0, inf) -> sRGB-ish uint8 (gamma 2.2)."""
    img = np.asarray(img, np.float32)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] uint8, or float (tonemapped), or [H, W]. The native
    library tonemaps a float image and encodes at zlib level 1 (its "up"
    filter path), as the JAX package's write_png does; where it cannot be
    built, `to_uint8` and the stdlib encoder (filter 0, level 6) run."""
    from .. import native

    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype != np.uint8:
        tm = native.tonemap_u8(np.clip(np.asarray(img, np.float32), 0.0, 1.0))
        img = tm if tm is not None else to_uint8(img)
    data = native.encode_png(img, compress_level=1)
    if data is None:
        data = encode_png_stdlib(img)
    with open(path, "wb") as f:
        f.write(data)


def encode_png_stdlib(img: np.ndarray, level: int = 6) -> bytes:
    """RGB8 [H, W, 3] -> PNG bytes with the standard library: filter 0 on
    every row, zlib at `level`."""
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def read_png_rgb(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB, no interlace), for round trips."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, ctype = struct.unpack(">IIBB", body[:10])
            if bit != 8 or ctype != 2:
                raise ValueError(f"{path}: only 8-bit RGB is supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
                             np.uint8).copy()
        if ftype == 1:  # sub
            for i in range(3, stride):
                line[i] = (int(line[i]) + int(line[i - 3])) & 0xFF
        elif ftype == 2:  # up
            line = ((line.astype(np.uint16) + prev) & 0xFF).astype(np.uint8)
        elif ftype == 3:  # average
            for i in range(stride):
                left = line[i - 3] if i >= 3 else 0
                line[i] = (int(line[i]) + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(line[i - 3]) if i >= 3 else 0
                b = int(prev[i])
                c = int(prev[i - 3]) if i >= 3 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (int(line[i]) + pred) & 0xFF
        out[y] = line.reshape(w, 3)
        prev = line
    return out
