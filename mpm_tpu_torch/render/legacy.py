"""The reference's dormant render paths, R12 (GPUParticles) and R13 (the
legacy full-screen-quad SSFR) (port of ``mpm_tpu.render.legacy``).

R12 places each particle from the sim's (pos.xyz, |vel|) texture by flat
index (particle_shader.gdshader:12-20: texel = (idx % width, idx / width))
and draws billboard sphere impostors writing packed NDC depth into the
colour channels: R = depth, G = fract(depth * 65536)
(particle_depth_map.gdshader). R13 unpacks the two-channel 16.16 depth
(screen_shader.gdshader:33-34), blurs it with a fixed-size separable
bilateral filter in linear depth (bilateral_blur.gdshader, with its colour
mode's quirk) and shows linear depth in grey (full_screen_quad.gdshader).

The texture is an RGBA32F array of width floor(sqrt(n)) + 1
(MLSMPM3DFluidMultithreadGPU.cs:196-197) indexed by particle id; the
packed-depth splat reuses the production splat (render/splat.py); the quad
chain is plain image math. A debug path with no kernel of its own.
"""

from __future__ import annotations

import math

import torch

from .camera import Camera, linear_depth_to_ndc, ndc_depth_to_linear, norm3
from .splat import BG_DEPTH, splat_particles

# screen_shader.gdshader:36-39: an unpacked depth below this was never drawn
# (reverse z: 0.0 is the far plane, the cleared value)
DEPTH_DISCARD = 1e-4


def pos_texture_width(n: int) -> int:
    """The texture side for n particles, floor(sqrt(n)) + 1 (exact isqrt;
    the reference truncates a float32 root, which can differ by one near
    n ~ 16.7M)."""
    return math.isqrt(n) + 1


def particle_pos_texture(pos: torch.Tensor, vel_mag: torch.Tensor, n: int) -> torch.Tensor:
    """[W, W, 4] float32 (pos.xyz, |vel|) texture from [3, n] positions in
    particle-id order (g2p.glsl:44,149-150); texels >= n are zero."""
    w = pos_texture_width(n)
    tex = torch.zeros((w * w, 4), dtype=torch.float32, device=pos.device)
    tex[:n, :3] = pos[:, :n].T.float()
    tex[:n, 3] = vel_mag[:n].float()
    return tex.reshape(w, w, 4)


def particle_pos_texture_from_state(state, n: int) -> torch.Tensor:
    """The texture from a BucketState: each live slot's (pos, |vel|) at
    texel ids[k, c] (the flat index is the particle id, so the layout holds
    across migrations); empty slots (ids -1) go to a guard texel past the
    end."""
    w = pos_texture_width(n)
    pos = state.pos.reshape(state.dim, -1).float()
    vel = state.vel.reshape(state.dim, -1).float()
    ids = state.ids.reshape(-1).long()
    live = ids >= 0
    idx = torch.where(live, ids, w * w)
    texel = torch.cat([pos.T, norm3(vel.T)[:, None]], dim=1)
    tex = torch.zeros((w * w + 1, 4), dtype=torch.float32, device=pos.device)
    tex[idx] = torch.where(live[:, None], texel, 0.0)
    return tex[: w * w].reshape(w, w, 4)


def particles_from_texture(tex: torch.Tensor, n: int):
    """The process shader's read (particle_shader.gdshader:12-20): (pos
    [3, n], |vel| [n]) of particles 0..n-1."""
    flat = tex.reshape(-1, 4)[:n]
    return flat[:, :3].T, flat[:, 3]


def pack_depth(ndc_depth: torch.Tensor) -> torch.Tensor:
    """[H, W] NDC depth -> [H, W, 3]: R = depth, G = fract(depth * 65536),
    B = 0 (particle_depth_map.gdshader)."""
    lo = ndc_depth * 65536.0
    return torch.stack([ndc_depth, lo - torch.floor(lo), torch.zeros_like(ndc_depth)], dim=-1)


def unpack_depth(packed: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] -> [H, W] NDC depth: floor(x * 65536) / 65536 +
    floor(y * 65536) / 65536^2 (screen_shader.gdshader:33-34). Discarded
    pixels stay 0."""
    hi = torch.floor(packed[..., 0] * 65536.0) / 65536.0
    lo = torch.floor(packed[..., 1] * 65536.0) / (65536.0 * 65536.0)
    return hi + lo


def packed_depth_splat(pos: torch.Tensor, view, cam: Camera, sphere_radius: float = 1.0,
                       max_radius_px: int = 6) -> torch.Tensor:
    """R12's draw pass: billboard sphere impostors with analytic depth (the
    production splat), as the [H, W, 3] packed NDC depth image; empty pixels
    (0, 0, 0), the far plane."""
    vmag = torch.zeros((pos.shape[-1],), dtype=torch.float32, device=pos.device)
    bufs = splat_particles(pos, vmag, view, cam, sphere_radius=sphere_radius,
                           max_radius_px=max_radius_px)
    occupied = bufs.depth < BG_DEPTH
    near = torch.tensor(cam.near, dtype=torch.float32, device=pos.device)
    ndc = torch.where(occupied, torch.clamp(linear_depth_to_ndc(
        torch.maximum(bufs.depth, near), cam), 0.0, 1.0), 0.0)
    return torch.where(occupied[..., None], pack_depth(ndc), 0.0)


def _tap_weight(t: int, two_s2: float, device) -> torch.Tensor:
    """exp(-(t * t) / (2 sigma^2)) in float32."""
    num = torch.tensor(-float(t * t), dtype=torch.float32, device=device)
    return torch.exp(num / torch.tensor(two_s2, dtype=torch.float32, device=device))


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[H, W, ...] padded by `pad` on both image axes, clamping to the edge
    (screen textures clamp)."""
    chw = x.reshape(1, *x.shape[:2], -1).permute(0, 3, 1, 2)
    p = torch.nn.functional.pad(chw, (pad, pad, pad, pad), mode="replicate")
    return p.permute(0, 2, 3, 1).reshape(x.shape[0] + 2 * pad, x.shape[1] + 2 * pad,
                                          *x.shape[2:])


def legacy_bilateral_blur_1d(linear_depth: torch.Tensor, blur_dir: tuple[int, int] = (1, 0),
                             filter_size: int = 50, sigma_range: float = 2.0) -> torch.Tensor:
    """The legacy non-adaptive separable bilateral blur, depth mode
    (bilateral_blur.gdshader, mode 0): fixed filter_size, sigma_space =
    filter_size / 3, Gaussian space x range weights over linear depth, edge
    taps clamped. Returns the blurred linear depth (before the shader's
    /100)."""
    h, w = linear_depth.shape
    dx, dy = blur_dir
    sigma_space = float(filter_size) / 3.0
    two_s2 = 2.0 * sigma_space * sigma_space
    two_r2 = torch.tensor(2.0 * sigma_range * sigma_range, dtype=torch.float32,
                          device=linear_depth.device)
    pad = filter_size
    padded = _edge_pad(linear_depth, pad)
    center = linear_depth
    s = torch.zeros_like(center)
    ws = torch.zeros_like(center)
    for i in range(2 * filter_size + 1):
        t = i - filter_size
        y0, x0 = pad + t * dy, pad + t * dx
        sample = padded[y0:y0 + h, x0:x0 + w]
        wgt = _tap_weight(t, two_s2, center.device)
        rd = sample - center
        wd = torch.exp(-rd * rd / two_r2)
        s = s + sample * wgt * wd
        ws = ws + wgt * wd
    return s / torch.clamp_min(ws, 1e-20)


def legacy_color_blur_1d(color: torch.Tensor, blur_dir: tuple[int, int] = (1, 0),
                         filter_size: int = 30, sigma_range: float = 1.0) -> torch.Tensor:
    """The legacy blur's colour mode (bilateral_blur.gdshader, mode 1), with
    its quirk kept: each channel's range weight compares the sample's red
    with that channel of the centre (`vec3 rDepth = sample.r - source`)."""
    h, w, _ = color.shape
    dx, dy = blur_dir
    sigma = float(filter_size) / 3.0
    two_s2 = 2.0 * sigma * sigma
    two_r2 = torch.tensor(2.0 * sigma_range * sigma_range, dtype=torch.float32,
                          device=color.device)
    pad = filter_size
    padded = _edge_pad(color, pad)
    center = color
    s = torch.zeros_like(center)
    ws = torch.zeros_like(center)
    for i in range(2 * filter_size + 1):
        t = i - filter_size
        y0, x0 = pad + t * dy, pad + t * dx
        sample = padded[y0:y0 + h, x0:x0 + w]
        wgt = _tap_weight(t, two_s2, center.device)
        rd = sample[..., 0:1] - center  # the sample.r-against-vec3 quirk
        wd = torch.exp(-rd * rd / two_r2)
        s = s + sample * wgt * wd
        ws = ws + wgt * wd
    return s / torch.clamp_min(ws, 1e-20)


def legacy_depth_view(ndc_depth: torch.Tensor, cam: Camera, bg_color: torch.Tensor,
                      depth_range: float = 50.0) -> torch.Tensor:
    """The linear-depth visualiser (full_screen_quad.gdshader:16-28): grey
    linear_depth / depth_range where the depth is below depth_range, the
    background elsewhere."""
    lin = ndc_depth_to_linear(torch.clamp_min(ndc_depth, 1e-9), cam)
    rng = torch.tensor(depth_range, dtype=torch.float32, device=lin.device)
    gray = torch.clamp(lin / rng, 0.0, 1.0)
    show = (lin < depth_range) & (ndc_depth >= DEPTH_DISCARD)
    return torch.where(show[..., None], gray[..., None], bg_color)


def legacy_quad_frame(state, n: int, view, cam: Camera, bg_color: torch.Tensor,
                      sphere_radius: float = 1.0, max_radius_px: int = 6,
                      filter_size: int = 50, sigma_range: float = 2.0) -> torch.Tensor:
    """The dormant pipeline end to end: bucket state -> id-ordered position
    texture (R12) -> packed-depth impostor splat (R12) -> 16.16 unpack
    (R13) -> linearise -> X then Y legacy bilateral blur -> /100 grey
    (bilateral_blur.gdshader:88) over the background where fluid was drawn."""
    tex = particle_pos_texture_from_state(state, n)
    return legacy_quad_from_texture(tex, n, view, cam, bg_color, sphere_radius=sphere_radius,
                                    max_radius_px=max_radius_px, filter_size=filter_size,
                                    sigma_range=sigma_range)


def legacy_quad_from_texture(tex: torch.Tensor, n: int, view, cam: Camera,
                             bg_color: torch.Tensor, sphere_radius: float = 1.0,
                             max_radius_px: int = 6, filter_size: int = 50,
                             sigma_range: float = 2.0) -> torch.Tensor:
    """legacy_quad_frame from the texture contract on."""
    pos, _vmag = particles_from_texture(tex, n)
    packed = packed_depth_splat(pos, view, cam, sphere_radius=sphere_radius,
                                max_radius_px=max_radius_px)
    ndc = unpack_depth(packed)
    fluid = ndc >= DEPTH_DISCARD
    lin = ndc_depth_to_linear(torch.clamp_min(ndc, 1e-9), cam)
    lin = torch.where(fluid, lin, cam.far)  # depth-0 taps linearise to far
    b = legacy_bilateral_blur_1d(lin, (1, 0), filter_size, sigma_range)
    b = legacy_bilateral_blur_1d(b, (0, 1), filter_size, sigma_range)
    gray = torch.clamp(b / torch.tensor(100.0, device=b.device), 0.0, 1.0)
    return torch.where(fluid[..., None], gray[..., None], bg_color)
