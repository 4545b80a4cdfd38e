"""2D scene frames (port of ``mpm_tpu.render.render2d``), in plain PyTorch.

The reference draws each 2D particle as a quad over a grid of cell sprites
(camera zoom 8). Here particles are binned to pixels with a sort and
segment bounds (no float atomics, so a frame is the same run to run),
dilated into dots, coloured by a velocity ramp over faint grid lines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fmath import sqrt_rn


def render_2d(pos: torch.Tensor, vel_mag: torch.Tensor, grid_res: tuple[int, int],
              scale: int = 8, live: torch.Tensor | None = None) -> torch.Tensor:
    """pos [2, N] in grid units, vel_mag [N], live [N] bool (dead bucket
    slots excluded) -> [H, W, 3] float on pos's device, W = res_x * scale,
    H = res_y * scale. x maps to image columns, y to rows (screen down)."""
    dev = pos.device
    w = grid_res[0] * scale
    h = grid_res[1] * scale
    px = torch.clamp((pos[0] * scale).to(torch.int32), 0, w - 1)
    py = torch.clamp((pos[1] * scale).to(torch.int32), 0, h - 1)
    pix = py * w + px
    if live is not None:
        # park dead slots one past the last pixel: the segment bounds below
        # cover only [0, h*w)
        pix = torch.where(live, pix, h * w)

    # per-pixel particle count and mean |v|: sort by pixel, segment bounds
    order = torch.argsort(pix, stable=True)
    pix_s = pix[order].contiguous()
    v_s = vel_mag[order]
    bounds = torch.searchsorted(pix_s, torch.arange(h * w + 1, dtype=pix_s.dtype, device=dev))
    count = (bounds[1:] - bounds[:-1]).to(torch.float32)
    cum_v = torch.cat([torch.zeros((1,), dtype=v_s.dtype, device=dev), torch.cumsum(v_s, 0)])
    sum_v = cum_v[bounds[1:]] - cum_v[bounds[:-1]]
    mean_v = torch.where(count > 0, sum_v / torch.clamp(count, min=1.0), 0.0)

    density = torch.clamp(count.reshape(h, w) / 2.0, 0.0, 1.0)
    speed = torch.clamp(mean_v.reshape(h, w) / 3.0, 0.0, 1.0)

    # dilate single-pixel hits into visible dots; both maps are >= 0, so the
    # -inf padding of max_pool2d gives what reduce_window's 0.0 init does
    r = max(1, scale // 4)
    both = F.max_pool2d(torch.stack([density, speed])[None], 2 * r + 1, stride=1, padding=r)[0]
    density, speed = both[0], both[1]

    # water-blue ramp shading toward white with speed
    base = torch.stack([0.10 + 0.8 * speed, 0.45 + 0.45 * speed, 0.85 + 0.1 * speed], dim=-1)
    fluid = base * density[..., None]

    # faint cell grid lines (the reference draws the grid as sprites)
    ys = torch.arange(h, device=dev) % scale == 0
    xs = torch.arange(w, device=dev) % scale == 0
    lines = (ys[:, None] | xs[None, :]).to(torch.float32) * 0.08
    bg = torch.full((h, w, 3), 0.02, device=dev) + lines[..., None]
    return torch.where(density[..., None] > 0, fluid, bg)


def bucket_frame_2d(state, grid_res: tuple[int, int], scale: int = 8) -> torch.Tensor:
    """The frame of a 2D bucket state: every live slot drawn, coloured by
    its |v| (mpm_tpu/__main__.py's _render_2d_loop)."""
    pos = state.pos.reshape(2, -1)
    vel = state.vel.reshape(2, -1).to(torch.float32)
    vmag = sqrt_rn(vel[0] * vel[0] + vel[1] * vel[1])
    return render_2d(pos, vmag, grid_res, scale=scale, live=state.mass.reshape(-1) > 0)
