"""Burned-in debug HUD (port of ``mpm_tpu.render.hud``), the headless
analogue of the reference's F3 debug overlay
(addons/debug_menu/debug_menu.gd:27,299-463): FPS, frame time
avg/min/max/last over a 150-frame window, the device/host split, and a
frame-time sparkline, drawn into the exported frame's top-left corner.

Host numpy on the frame after it has left the device (uint8 or float): the
overlay is UI, not simulation, as in the reference (a CanvasLayer drawn
after the 3D render). The render loops run it on their PNG worker threads."""

from __future__ import annotations

import numpy as np

from ..utils.timing import FrameStats

# 5x7 bitmap font for the HUD charset (rows of 5 bits, MSB left)
_GLYPHS = {
    "0": "0E 11 13 15 19 11 0E", "1": "04 0C 04 04 04 04 0E",
    "2": "0E 11 01 02 04 08 1F", "3": "1F 02 04 02 01 11 0E",
    "4": "02 06 0A 12 1F 02 02", "5": "1F 10 1E 01 01 11 0E",
    "6": "06 08 10 1E 11 11 0E", "7": "1F 01 02 04 08 08 08",
    "8": "0E 11 11 0E 11 11 0E", "9": "0E 11 11 0F 01 02 0C",
    ".": "00 00 00 00 00 0C 0C", " ": "00 00 00 00 00 00 00",
    "/": "01 01 02 04 08 10 10", ":": "00 0C 0C 00 0C 0C 00",
    "=": "00 00 1F 00 1F 00 00", "-": "00 00 00 1F 00 00 00",
    "F": "1F 10 10 1E 10 10 10", "P": "1E 11 11 1E 10 10 10",
    "S": "0F 10 10 0E 01 01 1E", "M": "11 1B 15 15 11 11 11",
    "A": "0E 11 11 1F 11 11 11", "V": "11 11 11 11 11 0A 04",
    "G": "0E 11 10 17 11 11 0F", "X": "11 11 0A 04 0A 11 11",
    "I": "0E 04 04 04 04 04 0E", "N": "11 19 15 13 11 11 11",
    "L": "10 10 10 10 10 10 1F", "T": "1F 04 04 04 04 04 04",
    "E": "1F 10 10 1E 10 10 1F", "K": "11 12 14 18 14 12 11",
    "C": "0E 11 10 10 10 11 0E", "U": "11 11 11 11 11 11 0E",
    "D": "1E 11 11 11 11 11 1E", "R": "1E 11 11 1E 14 12 11",
    "H": "11 11 11 1F 11 11 11", "O": "0E 11 11 11 11 11 0E",
    "|": "04 04 04 04 04 04 04",
}


def _draw_text(img: np.ndarray, x: int, y: int, text: str, color) -> None:
    h, w = img.shape[:2]
    cx = x
    for ch in text.upper():
        rows = _GLYPHS.get(ch, _GLYPHS[" "]).split()
        for ry, hexrow in enumerate(rows):
            bits = int(hexrow, 16)
            for rx in range(5):
                if bits & (1 << (4 - rx)):
                    py_, px_ = y + ry, cx + rx
                    if 0 <= py_ < h and 0 <= px_ < w:
                        img[py_, px_] = color
        cx += 6


def burn_in_hud(
    frame: np.ndarray, stats: FrameStats, extra: str = ""
) -> np.ndarray:
    """Draw the FPS/frametime overlay into a [H, W, 3] frame (float 0..1 or
    uint8). Modifies in place when writable (device transfers arrive
    read-only — those are copied)."""
    img = frame if frame.flags.writeable else frame.copy()
    is_u8 = img.dtype == np.uint8
    fg = np.asarray([255, 255, 255] if is_u8 else [1.0, 1.0, 1.0], img.dtype)
    bg_dim = 0.35
    s = stats.stats
    lines = [
        f"{s['fps']:6.1f} FPS",
        f"{s['avg_ms']:6.1f} MS AVG",
        f"{s['min_ms']:6.1f}/{s['max_ms']:6.1f} MIN/MAX",
        f"{s['last_ms']:6.1f} MS LAST",
    ]
    if s.get("dev_ms") or s.get("host_ms"):
        # the reference's separate CPU and GPU frame times
        # (debug_menu.gd:132,383,403)
        lines.append(f"DEV {s['dev_ms']:5.1f} | HOST {s['host_ms']:5.1f} MS")
    if extra:
        lines.append(extra)

    pad, lh = 4, 9
    box_w = 6 * max(len(t) for t in lines) + 2 * pad
    graph_h = 24
    box_h = lh * len(lines) + graph_h + 3 * pad
    h, w = img.shape[:2]
    bw, bh = min(box_w, w), min(box_h, h)
    region = img[:bh, :bw].astype(np.float32)
    img[:bh, :bw] = (region * bg_dim).astype(img.dtype)
    for i, text in enumerate(lines):
        _draw_text(img, pad, pad + i * lh, text, fg)

    # frametime history sparkline (debug_menu.gd:299-348)
    times = np.asarray(stats.times, np.float32)
    if times.size >= 2:
        gy0 = pad + len(lines) * lh + pad
        gw = bw - 2 * pad
        xs = np.linspace(0, times.size - 1, gw).astype(np.int32)
        ts = times[xs] * 1e3
        t_max = max(ts.max(), 1e-3)
        heights = np.clip(
            (ts / t_max * (graph_h - 1)).astype(np.int32), 0, graph_h - 1
        )
        for gx in range(gw):
            yy = gy0 + (graph_h - 1 - heights[gx])
            if yy < h and pad + gx < w:
                img[yy, pad + gx] = fg
    return img
