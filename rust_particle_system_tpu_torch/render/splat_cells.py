"""Cell-binned point splat: the camera-aware general splat through kernel K11.

Counterpart of ``rust_particle_system_tpu/render/splat_pallas.py``
(``splat_pallas``, whose Pallas kernel ``_splat_kernel`` is K11).  Particles
are binned into render cells of 8 x 8 pixels by the sort-based grid
(``ops/grid.py``) in the screen's pixel space, after the camera.  Only the
first ``capacity`` particles of a cell, in sort order, are drawn; the rest are
counted in ``Grid.overflow``.  Cell (cx, cy) owns the 16 x 16 pixel patch at
(8 cx - 4, 8 cy - 4): each of its drawn particles adds alpha * (r, g, b) and
alpha at the patch's pixel centres, alpha = 1 - smoothstep(0.8 r, r, d) with
alpha < 0.01 dropped (render_shader.wgsl:86-98).  The image is the sum of the
patches, cropped to [H, W], then :func:`splat_resolve`.  The sprite radius
is clipped at the patch edge, so ``max_radius_px`` must be <= the 4-pixel
margin.

:func:`raster_cells` is K11 (``csrc/splat_cells.cu``): a per-pixel gather
over the 2 x 2 patches that cover each pixel, written straight into the
accumulators.  :func:`splat_cells_plain` is JAX's own formulation in torch:
table gather, an alpha tile of ``[chunk, capacity, 256]``, patch sums and the
four-shift assembly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.cuda import _lib
from ..ops.grid import GridSpec, build_grid
from .splat import RenderSpec, splat_resolve, world_to_pixel

PATCH_STRIDE = 8  # render-cell extent in pixels
MARGIN = 4  # sprite-radius margin on each side
PATCH = PATCH_STRIDE + 2 * MARGIN  # 16: patch edge in pixels
FAR = 1.0e6  # empty slots sit here, far from every patch

# Plain version: (slot, pixel) elements per chunk of cells (64 MB per f32
# temporary; about 1 GB live at 1080p and capacity 64).
PLAIN_CHUNK_ELEMS = 1 << 24


def render_grid(spec: RenderSpec, capacity: int) -> GridSpec:
    """The pixel-space grid of 8 x 8 render cells covering the image."""
    return GridSpec(x_min=0.0, y_min=0.0, cell_size=float(PATCH_STRIDE),
                    gw=-(-spec.width // PATCH_STRIDE), gh=-(-spec.height // PATCH_STRIDE),
                    capacity=int(capacity))


def edge_scalars(radius_px) -> tuple:
    """(0.8 r, max(r - 0.8 r, 1e-6)) in float32, as the Pallas kernel forms
    them: the soft edge's start and width."""
    r = np.float32(radius_px)
    edge0 = np.float32(0.8) * r
    return float(edge0), float(max(r - edge0, np.float32(1e-6)))


@functools.lru_cache(maxsize=8)
def _fills(device: torch.device) -> torch.Tensor:
    """The empty slot's (x, y, r, g, b), copied to ``device`` once per process."""
    return torch.tensor([FAR, FAR, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)


def _assemble(patches, ghc: int, gwc: int, height: int, width: int):
    """[k, ncells, 256] patch sums -> [k, H, W]: every pixel lies in exactly
    2 x 2 patches, so the image is the sum of the four stride-shifted patch
    quadrants (added in the order (0, 0), (0, 1), (1, 0), (1, 1))."""
    k = patches.shape[0]
    S, M = PATCH_STRIDE, MARGIN
    p = patches.reshape(k, ghc, gwc, PATCH, PATCH)
    canvas = torch.zeros((k, ghc + 1, gwc + 1, S, S), dtype=patches.dtype,
                         device=patches.device)
    for qy in range(2):
        for qx in range(2):
            canvas[:, qy:qy + ghc, qx:qx + gwc] += p[:, :, :, qy * S:(qy + 1) * S,
                                                     qx * S:(qx + 1) * S]
    img = canvas.permute(0, 1, 3, 2, 4).reshape(k, (ghc + 1) * S, (gwc + 1) * S)
    return img[:, M:M + height, M:M + width]


def raster_cells_plain(px, py, color, grid, rspec: GridSpec, height: int, width: int,
                       scal: tuple):
    """Plain PyTorch version of K11 (needs ``grid.table``): ([H, W, 3], [H, W])
    accumulators, in the JAX kernel's order of operations, chunked over cells."""
    n, nc, cap = px.shape[0], rspec.num_cells, rspec.capacity
    dev = px.device
    edge0, width_t = scal[0], torch.full((), scal[1], dtype=torch.float32, device=dev)
    perm = grid.perm.long()
    vals = torch.stack([px, py, color[:, 0], color[:, 1], color[:, 2]], dim=-1)[perm]
    vals = torch.cat([vals, _fills(dev)[None]])  # row n: the empty slot
    pidx = torch.arange(PATCH * PATCH, device=dev)
    prow, pcol = pidx // PATCH, pidx % PATCH
    patches = torch.empty((4, nc, PATCH * PATCH), dtype=torch.float32, device=dev)
    step = max(1, PLAIN_CHUNK_ELEMS // (cap * PATCH * PATCH))
    for c0 in range(0, nc, step):
        c1 = min(nc, c0 + step)
        idx = grid.table[c0:c1]
        g = vals[torch.where(idx >= 0, idx, n).long()]  # [B, cap, 5]
        cell = torch.arange(c0, c1, device=dev)
        ox = (cell % rspec.gw) * PATCH_STRIDE - MARGIN
        oy = (cell // rspec.gw) * PATCH_STRIDE - MARGIN
        pix_x = (ox[:, None] + pcol).float() + 0.5  # [B, 256] pixel centres
        pix_y = (oy[:, None] + prow).float() + 0.5
        dx = pix_x[:, None, :] - g[..., 0:1]  # [B, cap, 256]
        dy = pix_y[:, None, :] - g[..., 1:2]
        dist = torch.sqrt(dx * dx + dy * dy)
        tt = ((dist - edge0) / width_t).clamp(0.0, 1.0)
        alpha = 1.0 - tt * tt * (3.0 - 2.0 * tt)
        alpha = torch.where(alpha < 0.01, 0.0, alpha)
        for ch in range(3):
            patches[ch, c0:c1] = (alpha * g[..., 2 + ch:3 + ch]).sum(1)
        patches[3, c0:c1] = alpha.sum(1)
    img = _assemble(patches, rspec.gh, rspec.gw, height, width)
    return img[:3].permute(1, 2, 0), img[3]


_raster = _lib.kernel("rps_splat_cells")


def raster_cells(px, py, color, grid, rspec: GridSpec, height: int, width: int,
                 scal: tuple):
    """Kernel K11: ([H, W, 3] premultiplied RGB, [H, W] coverage) of the
    pixel-space particles ``px, py`` ([n] f32) with colours ``color``
    ([n, >= 3] f32), binned by ``grid`` on ``rspec``.  ``scal`` is
    :func:`edge_scalars` of the radius.  Launches K11 for CUDA tensors (it
    reads ``perm`` and ``starts``, not the table); runs the plain version for
    CPU tensors."""
    if _lib.dispatch(px) == "plain":
        return raster_cells_plain(px, py, color, grid, rspec, height, width, scal)
    _lib.require_cuda_planes(px, py)
    n = px.shape[0]
    if (px.dim() != 1 or color.dim() != 2 or color.shape[0] != n or color.shape[1] < 3
            or color.dtype != torch.float32 or color.device != px.device
            or color.stride(1) != 1):
        raise ValueError("expected [n] pixel positions and [n, >= 3] float32 colours "
                         "with unit column stride, on one device")
    perm, starts = grid.perm, grid.starts
    if perm.dtype != torch.int32 or starts.dtype != torch.int32 or starts.numel() != (
            rspec.num_cells + 1):
        raise ValueError("expected int32 perm and [num_cells + 1] int32 starts")
    rgb = torch.empty(height, width, 3, dtype=torch.float32, device=px.device)
    a = torch.empty(height, width, dtype=torch.float32, device=px.device)
    _raster(px.data_ptr(), py.data_ptr(), color.data_ptr(), perm.data_ptr(),
            starts.contiguous().data_ptr(), rgb.data_ptr(), a.data_ptr(), color.stride(0),
            rspec.gw, rspec.gh, rspec.capacity, height, width, *scal)
    raster_cells.launches += 1
    return rgb, a


raster_cells.launches = 0


def raster_cells_inputs(pos, color, particle_size: float, bounds, spec: RenderSpec,
                        capacity: int = 64, camera=None, with_table: bool = True) -> tuple:
    """The arguments of :func:`raster_cells` and :func:`raster_cells_plain`
    for particles ``pos`` ([n, 2] world) with colours ``color``: the camera's
    pixel positions, binned into the render cells (the slot table only with
    ``with_table``; K11 reads ``perm`` and ``starts``).  Raises ValueError
    when ``spec.max_radius_px`` exceeds the 4-pixel margin."""
    if spec.max_radius_px > MARGIN:
        raise ValueError(f"sprite radius {spec.max_radius_px}px exceeds the {MARGIN}px "
                         "patch margin")
    px, py, sx, _ = world_to_pixel(pos, bounds, spec, camera)
    rspec = render_grid(spec, capacity)
    grid = build_grid(rspec, torch.stack([px, py], dim=-1), with_table=with_table)
    scal = edge_scalars(np.float32(particle_size) * np.float32(sx))
    return (px.contiguous(), py.contiguous(), color, grid, rspec, spec.height, spec.width,
            scal)


def _splat(pos, color, particle_size, bounds, spec: RenderSpec, background, capacity: int,
           return_overflow: bool, camera, plain: bool):
    args = raster_cells_inputs(pos, color, particle_size, bounds, spec, capacity, camera,
                               with_table=plain)
    rgb_acc, a_acc = (raster_cells_plain if plain else raster_cells)(*args)
    image = splat_resolve(rgb_acc, a_acc, background)
    return (image, args[3].overflow) if return_overflow else image


def splat_cells(pos, color, particle_size: float, bounds, spec: RenderSpec,
                background=(0.0, 0.0, 0.0, 1.0), capacity: int = 64,
                return_overflow: bool = False, camera=None):
    """Render particles to an [H, W, 4] float32 image through the render-cell
    binning: ``splat``'s signature and blend, with at most ``capacity``
    sprites per 8 x 8 pixel cell.  ``return_overflow=True`` also returns the
    count of sprites left out (an int32 tensor).  ``camera`` is a
    (cx, cy, zoom) pan/zoom triple, applied before the binning.  Launches K11
    for CUDA tensors; runs the plain version for CPU tensors.  Raises
    ValueError when ``spec.max_radius_px`` exceeds the 4-pixel margin."""
    plain = _lib.dispatch(pos) == "plain"
    return _splat(pos, color, particle_size, bounds, spec, background, capacity,
                  return_overflow, camera, plain)


def splat_cells_plain(pos, color, particle_size: float, bounds, spec: RenderSpec,
                      background=(0.0, 0.0, 0.0, 1.0), capacity: int = 64,
                      return_overflow: bool = False, camera=None):
    """:func:`splat_cells` through the plain version on any device (the
    card's checks hold K11 against it)."""
    return _splat(pos, color, particle_size, bounds, spec, background, capacity,
                  return_overflow, camera, True)
