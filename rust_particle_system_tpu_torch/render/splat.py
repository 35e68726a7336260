"""Point-splat rasterizer: the scatter-add reference, in plain PyTorch.

Counterpart of ``rust_particle_system_tpu/render/splat_jax.py`` (which has no
Pallas in it).  Every particle stamps a soft-edged disc of radius
``particle_size`` (in world units) into ``[H, W]`` accumulators:
``alpha = 1 - smoothstep(0.8r, r, d)``, discarded below 0.01
(render_shader.wgsl:86-98).  Compositing is the order-independent weighted
blend of the JAX package: premultiplied colour and coverage add up, then
:func:`splat_resolve` normalises by coverage over the background.

This is the image oracle the plane rasterizer (``splat_planes.py``) is held
against, and the path for any camera other than the identity.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """Static raster geometry.  ``max_radius_px`` bounds the scatter stamp, so it
    must be >= the particle radius in pixels."""

    width: int = 1920
    height: int = 1080
    max_radius_px: int = 4


def _f32(v) -> np.float32:
    return np.float32(v)


def world_to_pixel(pos, bounds, spec: RenderSpec, camera=None):
    """World -> continuous pixel coords (pixel centres at integer + 0.5).

    World y points up and image rows run down, so y flips.  ``camera`` is a
    ``(cx, cy, zoom)`` triple that pans the view centre to (cx, cy) and scales
    by zoom; ``None`` is the identity camera framing ``bounds`` exactly.
    Returns (px, py, sx, sy); the scales are formed in float32 from the f32
    bounds (and zoom), as the JAX package forms them."""
    x_min, x_max, y_min, y_max = (_f32(b) for b in bounds)
    sx = _f32(spec.width) / (x_max - x_min)
    sy = _f32(spec.height) / (y_max - y_min)
    if camera is None:
        px = (pos[..., 0] - float(x_min)) * float(sx)
        py = (float(y_max) - pos[..., 1]) * float(sy)
        return px, py, float(sx), float(sy)
    zoom = _f32(camera[2])
    sx, sy = sx * zoom, sy * zoom
    cx, cy = float(_f32(camera[0])), float(_f32(camera[1]))
    px = spec.width * 0.5 + (pos[..., 0] - cx) * float(sx)
    py = spec.height * 0.5 - (pos[..., 1] - cy) * float(sy)
    return px, py, float(sx), float(sy)


def _sprite_alpha(dist_px, radius_px: float):
    """Soft-disc coverage: 1 - smoothstep(0.8r, r, d), with the fragment
    shader's discard of alpha < 0.01.  Divides by the soft-edge width, as the
    JAX oracle does (a device-tensor divisor: on CUDA, PyTorch turns division
    by a host scalar into a multiply by its reciprocal)."""
    r = _f32(radius_px)
    edge0 = _f32(0.8) * r
    width = torch.full((), max(r - edge0, _f32(1e-6)), dtype=torch.float32,
                       device=dist_px.device)
    t = ((dist_px - float(edge0)) / width).clamp(0.0, 1.0)
    alpha = 1.0 - t * t * (3.0 - 2.0 * t)
    return torch.where(alpha < 0.01, 0.0, alpha)


def splat_accumulate(pos, color, particle_size: float, bounds, spec: RenderSpec,
                     camera=None):
    """Pre-resolve accumulators: ([H, W, 3] premultiplied RGB, [H, W] coverage).

    Each particle adds over the (2*max_radius_px+1)^2 stamp around its pixel;
    out-of-image pixels are dropped.  The accumulators are additive, so
    partial ones can be summed before :func:`splat_resolve`."""
    px, py, sx, _ = world_to_pixel(pos, bounds, spec, camera)
    radius_px = _f32(particle_size) * _f32(sx)
    H, W = spec.height, spec.width
    r = spec.max_radius_px
    off = torch.arange(-r, r + 1, dtype=torch.int32, device=pos.device)
    offy, offx = torch.meshgrid(off, off, indexing="ij")  # [s, s]
    ix = torch.floor(px).to(torch.int32)
    iy = torch.floor(py).to(torch.int32)
    cols = ix[:, None, None] + offx[None]  # [n, s, s]
    rows = iy[:, None, None] + offy[None]
    dist = torch.sqrt((cols.float() + 0.5 - px[:, None, None]) ** 2
                      + (rows.float() + 0.5 - py[:, None, None]) ** 2)
    alpha = _sprite_alpha(dist, radius_px)
    in_image = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    alpha = torch.where(in_image, alpha, 0.0)
    flat = torch.where(in_image, rows * W + cols, 0).reshape(-1).long()
    premul = (color[:, None, None, :3] * alpha[..., None]).reshape(-1, 3)
    rgb_acc = torch.zeros((H * W, 3), dtype=torch.float32, device=pos.device)
    a_acc = torch.zeros((H * W,), dtype=torch.float32, device=pos.device)
    rgb_acc.index_put_((flat,), premul, accumulate=True)
    a_acc.index_put_((flat,), alpha.reshape(-1), accumulate=True)
    return rgb_acc.reshape(H, W, 3), a_acc.reshape(H, W)


@functools.lru_cache(maxsize=8)
def _background(values: tuple, device: torch.device):
    """The background colour on ``device``, copied there once per process: a
    copy from pageable host memory every frame would hold the host until the
    card's stream drains."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def splat_resolve(rgb_acc, a_acc, background=(0.0, 0.0, 0.0, 1.0)):
    """Normalise accumulators into the final [H, W, 4] image over a background."""
    coverage = a_acc.clamp(0.0, 1.0)[..., None]
    mean_rgb = rgb_acc / a_acc.clamp_min(1e-6)[..., None]
    bg = _background(tuple(float(b) for b in background), rgb_acc.device)
    out_rgb = mean_rgb * coverage + bg[:3] * (1.0 - coverage)
    out_a = coverage + bg[3] * (1.0 - coverage)
    return torch.cat([out_rgb, out_a], dim=-1)


def splat(pos, color, particle_size: float, bounds, spec: RenderSpec,
          background=(0.0, 0.0, 0.0, 1.0), camera=None):
    """Render particles to an [H, W, 4] float32 image (RGB over the background,
    A = coverage).  Keep ``particle_size * zoom`` within ``max_radius_px``
    pixels, or sprites clip at the stamp edge."""
    rgb_acc, a_acc = splat_accumulate(pos, color, particle_size, bounds, spec, camera)
    return splat_resolve(rgb_acc, a_acc, background)


def to_srgb_u8(image):
    """Linear float image -> sRGB-encoded uint8 (the reference's
    Rgba8UnormSrgb target)."""
    rgb = image[..., :3].clamp(0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * rgb ** (1.0 / 2.4) - 0.055)
    a = image[..., 3:].clamp(0.0, 1.0)
    out = torch.cat([srgb, a], dim=-1)
    return torch.round(out * 255.0).to(torch.uint8)
