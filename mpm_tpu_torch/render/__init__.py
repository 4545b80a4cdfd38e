"""The SSFR renderer of the port (``mpm_tpu.render``): kernel X
(render/extract_kernel.py), the splat kernels (z-buffer and dilation,
render/splat_kernel.py), kernel BL (render/blur_kernel.py) and kernel SH
(render/shade_kernel.py) in CUDA, the rest in plain PyTorch; every render mode of the JAX package (legacy_quad
in render/legacy.py), the thickness pass, cubemap files, the particle-array
renderer; and the 2D frames of render/render2d.py."""

from .background import BackgroundScene, load_cubemap, make_cubemap_sampler
from .camera import Camera, linear_depth_to_ndc, look_at, ndc_depth_to_linear
from .image import write_png
from .pipeline import (
    RENDER_DEFAULT,
    RENDER_DEPTH_DEBUG,
    RENDER_LEGACY_QUAD,
    RENDER_LIT_SPHERES,
    RENDER_MODES,
    RENDER_NONE,
    RENDER_VELOCITY_SPHERES,
    RenderConfig,
    background_for_view,
    default_view,
    domain_crop,
    frame_to_u8,
    make_full_frame_step,
    make_renderer,
    render_frame,
    render_frame_buckets,
    render_frame_cells,
    render_frame_from_zbuffer,
)
from .render2d import bucket_frame_2d, render_2d
from .splat import (extract_band_slot_splats, splat_particles, surface_band_uncovered,
                    thickness_deposit)
from .ssfr import SSFRParams, gaussian_blur, thickness_map

__all__ = [
    "BackgroundScene",
    "Camera",
    "RENDER_DEFAULT",
    "RENDER_DEPTH_DEBUG",
    "RENDER_LEGACY_QUAD",
    "RENDER_LIT_SPHERES",
    "RENDER_MODES",
    "RENDER_NONE",
    "RENDER_VELOCITY_SPHERES",
    "RenderConfig",
    "SSFRParams",
    "background_for_view",
    "bucket_frame_2d",
    "default_view",
    "domain_crop",
    "extract_band_slot_splats",
    "frame_to_u8",
    "gaussian_blur",
    "linear_depth_to_ndc",
    "load_cubemap",
    "look_at",
    "make_cubemap_sampler",
    "make_full_frame_step",
    "make_renderer",
    "ndc_depth_to_linear",
    "render_2d",
    "render_frame",
    "render_frame_buckets",
    "render_frame_cells",
    "render_frame_from_zbuffer",
    "splat_particles",
    "surface_band_uncovered",
    "thickness_deposit",
    "thickness_map",
    "write_png",
]
