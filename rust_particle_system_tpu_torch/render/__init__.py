"""Rendering: the general scatter-add splat (``splat.py``) and the plane
rasterizer of the fused frame (``splat_planes.py``, kernel K4)."""

from .splat import (
    RenderSpec,
    splat,
    splat_accumulate,
    splat_resolve,
    to_srgb_u8,
    world_to_pixel,
)

__all__ = [
    "RenderSpec",
    "splat",
    "splat_accumulate",
    "splat_resolve",
    "to_srgb_u8",
    "world_to_pixel",
]
