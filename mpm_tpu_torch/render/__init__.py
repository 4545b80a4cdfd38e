"""The SSFR renderer of the port (``mpm_tpu.render``'s bucket-state path):
kernel X (render/extract_kernel.py) and kernel BL (render/blur_kernel.py)
in CUDA, the rest in plain PyTorch."""

from .background import BackgroundScene
from .camera import Camera, look_at
from .image import write_png
from .pipeline import (
    RENDER_DEFAULT,
    RENDER_NONE,
    RenderConfig,
    background_for_view,
    default_view,
    domain_crop,
    frame_to_u8,
    make_full_frame_step,
    render_frame_buckets,
    render_frame_cells,
)
from .splat import extract_band_slot_splats, surface_band_uncovered
from .ssfr import SSFRParams

__all__ = [
    "BackgroundScene",
    "Camera",
    "RENDER_DEFAULT",
    "RENDER_NONE",
    "RenderConfig",
    "SSFRParams",
    "background_for_view",
    "default_view",
    "domain_crop",
    "extract_band_slot_splats",
    "frame_to_u8",
    "look_at",
    "make_full_frame_step",
    "render_frame_buckets",
    "render_frame_cells",
    "surface_band_uncovered",
    "write_png",
]
