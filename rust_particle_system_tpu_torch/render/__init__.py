"""Rendering: the general scatter-add splat (``splat.py``), the cell-binned
splat (``splat_cells.py``, kernel K11) and the plane rasterizer of the fused
frame (``splat_planes.py``, kernel K4)."""

from .splat import (
    RenderSpec,
    splat,
    splat_accumulate,
    splat_resolve,
    to_srgb_u8,
    world_to_pixel,
)
from .splat_cells import splat_cells

__all__ = [
    "RenderSpec",
    "splat",
    "splat_accumulate",
    "splat_cells",
    "splat_resolve",
    "to_srgb_u8",
    "world_to_pixel",
]
