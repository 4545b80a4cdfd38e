"""The yardstick of the thickness pass (splat.thickness_deposit, then
ssfr.thickness_map's Gaussian and floor), for bench_torch/roofline.bound_ms:
the work any implementation of the pass must do, so that a later fused
kernel cannot read above 100%.

Bytes: the four fields of each splat point it reads (pixel x, pixel y,
depth and count, 4 B each), and the crop's map written once, float32.
Operations: the separable Gaussian's multiply and add a tap, 2 radius + 1
taps a pass, two passes, a pixel of the crop. The deposit's weights and the
floor are left out, as is every intermediate buffer: each is a choice of
the implementation."""

from __future__ import annotations

POINT_BYTES = 16  # x, y, depth, count: float32 each


def thickness_work(points: int, ch: int, cw: int, radius: int) -> tuple[int, int]:
    """(bytes, operations) of the pass over `points` splat points and a
    crop of ch x cw pixels, Gaussian of radius `radius`."""
    pixels = ch * cw
    return POINT_BYTES * points + 4 * pixels, 2 * (2 * radius + 1) * 2 * pixels
