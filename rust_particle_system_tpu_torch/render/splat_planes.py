"""Fused-frame renderer: patch splat straight from the simulation's cell planes.

Counterpart of ``rust_particle_system_tpu/render/splat_planes.py``.  The SPH
step already holds the particles in cell planes ``[gh, gw, C]``; this renderer
draws them from there, so a render costs one kernel and no binning at all.

Each cell owns a pixel patch of ``(sy + 2m) x (sx + 2m)`` around its
``sy x sx`` pixel footprint (m = the patch margin), and each of its live slots
draws a soft disc into that patch only.  :func:`raster_planes` is kernel K4
(``csrc/splat_planes.cu``), the whole render: world planes in, the
``[H, W, 4]`` image out (or its ``[nch, H, W]`` accumulators), with world ->
pixel, the colour, the sum rule and the resolve inside it.  It replaces both
Pallas rasterizers, the v2 row-strip kernel ``_make_strip_kernel_v2`` (K4)
and its v1 fallback ``_make_strip_kernel`` (K10), and the JAX elementwise
steps around them: the CUDA kernel has neither the TPU's 32-row patch limit
nor its 128-lane group span, so one kernel covers both geometries.  Its
plain PyTorch version, :func:`raster_planes_composed`, is the composition of
:func:`raster_inputs`' staging, :func:`raster_planes_plain` (the
accumulators), :func:`accumulators` (the sum rule) and ``splat_resolve``.

Preconditions (as in JAX): integral pixel strides, stride >= 2*margin,
sprite radius <= margin, and the world grid covering the image rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.kernels import energy_color
from ..ops.cuda import _lib
from ..ops.cuda.rebin import SENTINEL
from ..ops.cuda.sph import _live_slot_bound
from ..ops.grid import GridSpec
from .splat import RenderSpec, splat_resolve

MARGIN = 4
FAR = SENTINEL  # dead slots park here, far outside every patch
WHITE = "white"  # colors=WHITE: every live slot draws (1, 1, 1) (warm-up frames)
BLACK = (0.0, 0.0, 0.0, 1.0)  # the default background (RGBA)

# Plain version: (slot, pixel) elements per row chunk (about 128 MB per f32
# temporary).
PLAIN_CHUNK_ELEMS = 1 << 25


def planes_compatible(grid_spec, render_spec, bounds, margin: int) -> bool:
    """True iff the plane rasterizer's static preconditions hold for this
    geometry, with the JAX package's bounds: integral pixel strides,
    stride >= 2*margin, patch width <= 32, and sprite radius <= margin.  Other
    geometries render through the general splat."""
    x_min, x_max, y_min, y_max = (float(b) for b in bounds)
    sx_px = grid_spec.cell_width * (render_spec.width / (x_max - x_min))
    sy_px = grid_spec.cell_size * (render_spec.height / (y_max - y_min))
    if abs(sx_px - round(sx_px)) > 1e-6 or abs(sy_px - round(sy_px)) > 1e-6:
        return False
    if min(round(sx_px), round(sy_px)) < 2 * margin:
        return False
    if round(sx_px) + 2 * margin > 32:
        return False
    return render_spec.max_radius_px <= margin


def drifted_patch_margin(grid_spec, render_spec, bounds, patch_margin=None) -> int:
    """Patch margin for renders of drifted planes (the fused frame and
    ``render_plane_state``, whose positions moved at most one integration past
    their binned cell).

    Default: the tight patch, sprite radius + 1 px of drift slack, capped so
    that stride >= 2*margin holds (the slack goes first, the radius floor
    last).  An explicit ``patch_margin`` asks for a wider patch, floored at
    the sprite radius and capped at :data:`MARGIN`."""
    x_min, x_max, y_min, y_max = (float(b) for b in bounds)
    sx_px = int(round(grid_spec.cell_width * render_spec.width / (x_max - x_min)))
    sy_px = int(round(grid_spec.cell_size * render_spec.height / (y_max - y_min)))
    stride_cap = min(sx_px, sy_px) // 2
    if patch_margin is None:
        margin = min(render_spec.max_radius_px + 1, stride_cap)
    else:
        margin = min(MARGIN, max(patch_margin, render_spec.max_radius_px))
    return max(margin, render_spec.max_radius_px)


def _clamp_center(q, radius: float, hi: float):
    """Clamp a live sprite centre into [radius, hi - radius] of its patch, so
    an over-drifted sprite renders displaced instead of clipped; dead slots
    (parked near FAR) stay parked."""
    qc = q.clamp(radius, float(np.float32(hi) - np.float32(radius)))
    return torch.where(q > 0.1 * FAR, q, qc)


def raster_planes_plain(ppx, ppy, cols, geom: tuple, scal: tuple, clamp_drift: bool):
    """K4's accumulators in plain PyTorch, from pixel-space planes (dead slots
    at FAR) and colour planes: per-cell patch accumulators evaluated in row
    chunks, then summed into the ``[len(cols) + 1, H, W]`` image by ``F.fold``
    (patches overlap their neighbours by 2m pixels)."""
    H, W, sx, sy, m = geom
    radius, edge0, inv_w = scal
    gh, gw, C = ppx.shape
    ph, pw = sy + 2 * m, sx + 2 * m
    nch = len(cols) + 1
    dev = ppx.device
    patches = torch.zeros((nch, gh, gw, ph, pw), dtype=torch.float32, device=dev)
    x0 = (torch.arange(gw, dtype=torch.float32, device=dev) * sx - m)[:, None]
    jc = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    ic = torch.arange(ph, dtype=torch.float32, device=dev) + 0.5
    step = max(1, PLAIN_CHUNK_ELEMS // (gw * C * ph * pw))
    for r0 in range(0, gh, step):
        r1 = min(gh, r0 + step)
        c = _live_slot_bound(ppx, r0, r1)  # higher slots are dead: they draw nothing
        if c == 0:
            continue
        rows = torch.arange(r0, r1, dtype=torch.float32, device=dev)
        y0 = (H - (rows + 1) * sy - m)[:, None, None]
        qx = ppx[r0:r1, :, :c] - x0  # [R, gw, c], patch coordinates
        qy = ppy[r0:r1, :, :c] - y0
        if clamp_drift:
            qx = _clamp_center(qx, radius, pw)
            qy = _clamp_center(qy, radius, ph)
        dx = jc - qx[..., None]  # [R, gw, c, pw]
        dy = ic - qy[..., None]  # [R, gw, c, ph]
        d = torch.sqrt(dx[..., None, :] * dx[..., None, :]
                       + dy[..., :, None] * dy[..., :, None])  # [R, gw, c, ph, pw]
        tt = ((d - edge0) * inv_w).clamp(0.0, 1.0)
        alpha = 1.0 - tt * tt * (3.0 - 2.0 * tt)
        alpha = torch.where(alpha < 0.01, 0.0, alpha)
        for k, col in enumerate(cols):
            patches[k, r0:r1] = (col[r0:r1, :, :c, None, None] * alpha).sum(2)
        patches[nch - 1, r0:r1] = alpha.sum(2)
    # Cell row wr's patch starts at image row H - (wr+1)*sy - m: top world row
    # first, block (rr, c) of the fold sits at canvas (rr*sy, c*sx), and the
    # canvas is the image shifted by (m + off, m) with off = gh*sy - H.
    blocks = patches.flip(1).permute(0, 3, 4, 1, 2).reshape(1, nch * ph * pw, gh * gw)
    canvas = F.fold(blocks, (gh * sy + 2 * m, gw * sx + 2 * m), (ph, pw),
                    stride=(sy, sx))[0]
    off = gh * sy - H
    img = canvas[:, m + off: m + off + H, m: m + W]
    if img.shape[2] < W:  # the grid ends left of the image's right edge
        img = F.pad(img, (0, W - img.shape[2]))
    return img.contiguous()


def render_geometry(bounds_static, grid_spec: GridSpec, render_spec: RenderSpec,
                    margin: int, particle_size: float) -> tuple:
    """K4's static geometry, ``(geom, scal, world)``: ``geom = (H, W, sx, sy,
    margin)`` in pixels, ``scal`` = :func:`raster_scalars` and ``world = (x_min,
    y_max, sx_scale, sy_scale)``, each formed in float32 as the JAX package
    forms it.  Checks the static preconditions (ValueError); cached, so a
    frame pays one lookup."""
    return _geometry(tuple(float(b) for b in bounds_static), grid_spec, render_spec,
                     int(margin), float(particle_size))


@functools.lru_cache(maxsize=64)
def _geometry(bounds: tuple, g: GridSpec, rs: RenderSpec, margin: int,
              particle_size: float) -> tuple:
    x_min, x_max, y_min, y_max = bounds
    sx_scale = rs.width / (x_max - x_min)
    sy_scale = rs.height / (y_max - y_min)
    sx_px = int(round(g.cell_width * sx_scale))
    sy_px = int(round(g.cell_size * sy_scale))
    if (abs(sx_px - g.cell_width * sx_scale) >= 1e-6
            or abs(sy_px - g.cell_size * sy_scale) >= 1e-6):
        raise ValueError("pixel strides must be integral")
    if min(sx_px, sy_px) < 2 * margin:
        raise ValueError("pixel stride must be >= 2*margin")
    if rs.max_radius_px > margin:
        raise ValueError("max_radius_px must be <= margin")
    f32 = lambda v: float(np.float32(v))
    geom = (rs.height, rs.width, sx_px, sy_px, margin)
    world = (f32(x_min), f32(y_max), f32(sx_scale), f32(sy_scale))
    return geom, raster_scalars(particle_size, sx_scale), world


def _check_rows(px, geom: tuple) -> None:
    if px.shape[0] * geom[3] < geom[0]:
        raise ValueError("the world grid must cover the image rows")


def _staged(px, py, vx, vy, live, world: tuple, max_energy: float, colors, color_sum):
    """The plain staging of K4: world -> pixel with dead slots parked at FAR,
    and the colour planes (the energy ramp of (vx, vy), white, or ``colors``)
    zeroed at dead slots; blue is left out under the sum rule."""
    x_min, y_max, sx_scale, sy_scale = world
    ppx = torch.where(live, (px - x_min) * sx_scale, FAR)
    ppy = torch.where(live, (y_max - py) * sy_scale, FAR)
    if colors is None:
        rgb = energy_color(torch.stack([vx, vy], dim=-1), max_energy)
        colors = (rgb[..., 0], rgb[..., 1], rgb[..., 2])
    elif isinstance(colors, str):  # WHITE
        one = torch.ones_like(px)
        colors = (one, one, one)
    cols = [torch.where(live, c, 0.0)
            for c in (colors[:2] if color_sum is not None else colors)]
    return ppx, ppy, cols


def raster_inputs(px, py, vx, vy, live, particle_size: float, max_energy: float, *,
                  bounds_static: tuple, grid_spec: GridSpec, render_spec: RenderSpec,
                  margin: int, colors=None, color_sum: float | None = None):
    """:func:`raster_planes_plain`'s inputs from world-space planes: (ppx, ppy,
    cols, geom, scal).

    Elementwise in plane space: world -> pixel, dead slots parked at FAR,
    colours (the energy ramp of (vx, vy) unless ``colors`` is given, or
    :data:`WHITE`) zeroed at dead slots; blue is left out under the sum rule.
    Checks the static preconditions."""
    geom, scal, world = render_geometry(bounds_static, grid_spec, render_spec, margin,
                                        particle_size)
    _check_rows(px, geom)
    ppx, ppy, cols = _staged(px, py, vx, vy, live, world, max_energy, colors, color_sum)
    return ppx, ppy, cols, geom, scal


def accumulators(acc, color_sum: float | None) -> tuple:
    """``(rgb_acc [H, W, 3], a_acc [H, W])`` of ``[nch, H, W]`` accumulators;
    under the sum rule (every live slot's r+g+b == ``color_sum``) blue is
    linear in the others: ``color_sum * a - r - g``."""
    if color_sum is not None:
        blue = float(np.float32(color_sum)) * acc[2] - acc[0] - acc[1]
        return torch.stack([acc[0], acc[1], blue], dim=-1), acc[2]
    return acc[:3].permute(1, 2, 0), acc[3]


def raster_planes_composed(px, py, vx, vy, geometry: tuple, max_energy: float, *,
                           colors=None, color_sum: float | None = None,
                           clamp_drift: bool = False, background=BLACK):
    """Plain PyTorch version of K4, the composition :func:`_staged` ->
    :func:`raster_planes_plain` -> :func:`accumulators` ->
    :func:`splat_resolve`; with ``background=None`` it stops at the
    ``[nch, H, W]`` accumulators."""
    geom, scal, world = geometry
    _check_rows(px, geom)
    ppx, ppy, cols = _staged(px, py, vx, vy, px < 0.5 * FAR, world, max_energy, colors,
                             color_sum)
    acc = raster_planes_plain(ppx, ppy, cols, geom, scal, clamp_drift)
    if background is None:
        return acc
    return splat_resolve(*accumulators(acc, color_sum), background)


_raster = _lib.kernel("rps_splat_planes")
_COLOUR = {"ramp": 0, "given": 1, WHITE: 2}  # csrc/splat_planes.cu's Colour


def raster_planes(px, py, vx, vy, geometry: tuple, max_energy: float, *, colors=None,
                  color_sum: float | None = None, clamp_drift: bool = False,
                  background=BLACK):
    """Kernel K4, the whole plane render: world-space planes ``px, py`` (dead
    slots at FAR) in, the ``[H, W, 4]`` image over ``background`` out, or with
    ``background=None`` the ``[nch, H, W]`` accumulators (each colour x alpha,
    then alpha; nch = 3 under the sum rule, else 4).

    ``geometry`` is :func:`render_geometry`'s.  Colours: the energy ramp of
    ``(vx, vy)`` (``colors=None``), :data:`WHITE`, or an (r, g, b) tuple of
    planes.  ``color_sum``: every live slot's r+g+b equals it, so only (r, g,
    alpha) are summed and blue is rebuilt.  ``clamp_drift`` clamps live sprite
    centres into their patch.  Launches K4 for CUDA tensors (one launch and
    the output's allocation, nothing else); runs :func:`raster_planes_composed`
    for CPU tensors."""
    if _lib.dispatch(px) == "plain":
        return raster_planes_composed(px, py, vx, vy, geometry, max_energy, colors=colors,
                                      color_sum=color_sum, clamp_drift=clamp_drift,
                                      background=background)
    geom, scal, world = geometry
    _check_rows(px, geom)
    if colors is None:
        colour, cols, vel = _COLOUR["ramp"], (), (vx, vy)
    elif isinstance(colors, str):
        colour, cols, vel = _COLOUR[colors], (), ()
    else:
        colour, vel = _COLOUR["given"], ()
        cols = colors[:2] if color_sum is not None else colors[:3]
    _lib.require_cuda_planes(px, py, *vel, *cols)
    H, W, sx, sy, m = geom
    gh, gw, C = px.shape
    nch = 4 if color_sum is None else 3
    if background is None:
        out = torch.empty(nch, H, W, dtype=torch.float32, device=px.device)
    else:
        out = torch.empty(H, W, 4, dtype=torch.float32, device=px.device)
    vptr = [t.data_ptr() for t in vel] or [0, 0]
    cptr = [t.data_ptr() for t in cols] + [0] * (3 - len(cols))
    _raster(px.data_ptr(), py.data_ptr(), *vptr, *cptr, out.data_ptr(), gh, gw, C, H, W,
            sx, sy, m, nch, colour, int(clamp_drift), int(background is not None), *scal,
            *world, max_energy, 0.0 if color_sum is None else color_sum,
            *(BLACK if background is None else background))
    raster_planes.launches += 1
    return out


raster_planes.launches = 0


def raster_scalars(particle_size: float, sx_scale: float) -> tuple:
    """(radius, 0.8 * radius, 1 / max(radius - 0.8 * radius, 1e-6)) in pixels,
    each formed in float32 as the JAX package forms them."""
    r = np.float32(particle_size) * np.float32(sx_scale)
    edge0 = np.float32(0.8) * r
    inv_w = np.float32(1.0) / max(r - edge0, np.float32(1e-6))
    return float(r), float(edge0), float(inv_w)


def splat_from_planes(px, py, vx, vy, live, particle_size: float, max_energy: float,
                      *, bounds_static: tuple, grid_spec: GridSpec,
                      render_spec: RenderSpec, background=BLACK,
                      margin: int | None = None, colors=None, resolve: bool = True,
                      color_sum: float | None = None, clamp_drift: bool = False):
    """Render from sim cell planes (``[gh, gw, C]`` world-space position and
    velocity, and the live mask) through K4 (:func:`raster_planes`).

    Colours are the kinetic-energy ramp of (vx, vy) per slot, unless
    ``colors`` (an (r, g, b) tuple of planes, or :data:`WHITE`) gives them.
    Returns an ``[H, W, 4]`` image, or the raw ``(rgb_acc [H, W, 3], a_acc
    [H, W])`` accumulators when ``resolve=False``.

    ``margin`` (default :data:`MARGIN`) bounds sprite-centre drift outside the
    binning cell plus the sprite radius.  ``color_sum``: the caller asserts
    that every live slot's r+g+b equals it (the ramp sums to 1, warm-up white
    to 3); the kernel then accumulates (r, g, alpha) only, and blue is rebuilt
    as ``color_sum * a - r - g``.  ``clamp_drift`` clamps live sprite centres
    into their patch, so a sprite drifted beyond ``margin - radius`` renders
    displaced instead of clipped.  Slots outside ``live`` are parked at FAR
    first (one ``where``); the model paths call :func:`raster_planes` on
    planes whose dead slots are parked already."""
    geometry = render_geometry(bounds_static, grid_spec, render_spec,
                               MARGIN if margin is None else margin, particle_size)
    out = raster_planes(torch.where(live, px, FAR), py, vx, vy, geometry, max_energy,
                        colors=colors, color_sum=color_sum, clamp_drift=clamp_drift,
                        background=background if resolve else None)
    return out if resolve else accumulators(out, color_sum)
