"""Plane-resident rebin: the per-frame neighbour-structure rebuild without a sort.

Counterpart of ``rust_particle_system_tpu/ops/pallas/rebin.py``, variant 6 (the
lossless row-fused hole-fill; bit-identical to variant 5) only.  Kernel K1
(``csrc/rebin.cu``) replaces the Pallas ``_make_kernel_v6`` on the whole grid
(:func:`rebin_planes`, JAX ``_rebin_v6``); kernel K7, the same CUDA kernels
on one band's slab with its ghost rows and global row offset, replaces it as
driven by ``_rebin_v6_band`` (:func:`rebin_planes_band`, for the band-sharded
mesh).

Contract (pinned bit-for-bit against the JAX package by the tests): a cell's
stayers keep their slots; movers whose (clamped, one-cell) hop lands in a
neighbour fill that neighbour's DEAD slots in candidate order — pass Y takes
row r-1 then row r+1, pass X column c-1 then column c+1, slot order within
each; a mover that no neighbour adopts is retained in its slot.  Nothing is
ever dropped.  ``counts`` are the per-cell live totals after both passes.

K1 is memory-bound on the H100 (two passes of ~10 plane reads and 5 writes per
slot); its ranks come from warp ballots and popcounts instead of the TPU's
triangular and one-hot matmuls, and its two passes are two launches because a
whole grid row (548 KB at the main-path shape) exceeds a block's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid import GridSpec, cell_index
from . import _lib

SENTINEL = 1.0e6  # dead-slot parking position


def _fills(planes, fills) -> tuple:
    """Per-channel dead-slot fills (default SENTINEL for x/y, else 0)."""
    if fills is None:
        return tuple(SENTINEL if c < 2 else 0.0 for c in range(len(planes)))
    fills = tuple(float(f) for f in fills)
    # A filled slot must read as dead: the counts (and the JAX kernel's
    # air-row skip, which writes counts of 0) rely on it.
    if not fills[0] >= 0.5 * SENTINEL:
        raise ValueError("fills[0] must park dead slots at SENTINEL")
    return fills


def require_variant_6(variant: int) -> None:
    """Only the lossless variant 6 of the rebin is ported."""
    if variant != 6:
        raise NotImplementedError(
            f"rebin variant {variant} is not ported: variants 4 and 5 are the "
            f"separable hole-fill kernel K9 (rebin.py:_make_kernel_v4), still to "
            f"port; the port implements the lossless variant 6 (bit-identical to 5)")


def _shift(p: torch.Tensor, d: int, dim: int, fill: float) -> torch.Tensor:
    """Value at index i along ``dim`` comes from index i + d; ``fill`` outside."""
    out = torch.full_like(p, fill)
    n = p.shape[dim]
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, 0, n - d).copy_(p.narrow(dim, d, n - d))
    else:
        out.narrow(dim, -d, n + d).copy_(p.narrow(dim, 0, n + d))
    return out


def _hole_fill(own, win, keep, stay, fills):
    """One hole-fill pass over every cell at once.

    ``own``: per-channel ``[gh, gw, C]``; ``win``: per-channel ``[gh, gw, 2C]``
    candidate windows; ``keep`` ``[gh, gw, 2C]`` (candidates that move here);
    ``stay`` ``[gh, gw, C]``.  The candidate of window rank j fills the own dead
    slot of rank j while j < #holes.  Returns (per-channel outputs, the adopted
    mask over the window)."""
    C = own[0].shape[-1]
    dead = ~(own[0] < 0.5 * SENTINEL)
    arank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    hrank = torch.cumsum(dead.to(torch.int32), dim=-1) - 1
    n_arr = keep.sum(dim=-1, keepdim=True)
    n_holes = dead.sum(dim=-1, keepdim=True)
    adopted = keep & (arank < n_holes)
    # Window index of the arrival of each rank (rank C is a dump slot).
    dest = torch.where(adopted, arank, C).long()
    widx = torch.arange(2 * C, device=keep.device).expand_as(dest)
    src = torch.zeros(dest.shape[:-1] + (C + 1,), dtype=torch.long,
                      device=keep.device)
    src.scatter_(-1, dest, widx)
    filled = dead & (hrank < n_arr)
    pick = src.gather(-1, hrank.clamp(0, C - 1).long())
    outs = []
    for o, w, f in zip(own, win, fills):
        arrival = w.gather(-1, pick)
        outs.append(torch.where(stay, o, torch.where(filled, arrival, f)))
    return outs, adopted


def _rebin_rows_plain(ext, spec: GridSpec, fills: tuple, row0: int):
    """K1's logic on the own rows of extended planes: ``ext`` per channel holds
    global rows row0-2 .. row0+R (2 rows below the R own rows, 1 above).
    Every row test is in global rows, so rows outside the grid are never
    read, whatever they hold."""
    gh, gw = spec.gh, spec.gw
    R = ext[0].shape[0] - 3
    dev = ext[0].device
    rows = (row0 + torch.arange(R, device=dev)).view(R, 1, 1)
    cols = torch.arange(gw, device=dev).view(1, gw, 1)
    live = lambda x: x < 0.5 * SENTINEL
    key_x = lambda x: cell_index(x, spec.x_min, spec.cell_width, gw)
    key_y = lambda y: cell_index(y, spec.y_min, spec.cell_size, gh)
    planes = [p[2: R + 2] for p in ext]

    # ---- pass Y: cell (r, c) adopts from (r-1, c) then (r+1, c) ----
    x0, y0 = planes[0], planes[1]
    live0, ky0 = live(x0), key_y(y0)
    up = [p[1: R + 1] for p in ext]
    dn = [p[3: R + 3] for p in ext]
    keep_up = live(up[0]) & (rows >= 1) & (key_y(up[1]) >= rows)
    keep_dn = live(dn[0]) & (rows <= gh - 2) & (key_y(dn[1]) <= rows)
    win = [torch.cat([u, d], dim=-1) for u, d in zip(up, dn)]
    out_y, _ = _hole_fill(planes, win, torch.cat([keep_up, keep_dn], dim=-1),
                          live0 & (ky0 == rows), fills)

    # ---- Y-retention: did row r-1 / r+1 adopt row r's mover? ----
    x2, y2 = ext[0][:R], ext[1][:R]
    keep_m2 = live(x2) & (rows >= 2) & (key_y(y2) >= rows - 1)
    into_up = live0 & (ky0 <= rows - 1) & (rows >= 1)
    rank_up = (keep_m2.sum(-1, keepdim=True)
               + torch.cumsum(into_up.to(torch.int32), -1) - 1)
    adopted_up = into_up & (rank_up < (~live(up[0])).sum(-1, keepdim=True))
    into_dn = live0 & (ky0 >= rows + 1) & (rows <= gh - 2)
    rank_dn = torch.cumsum(into_dn.to(torch.int32), -1) - 1
    adopted_dn = into_dn & (rank_dn < (~live(dn[0])).sum(-1, keepdim=True))
    retain = live0 & (ky0 != rows) & ~(adopted_up | adopted_dn)
    mid = [torch.where(retain, p, o) for p, o in zip(planes, out_y)]

    # ---- pass X: cell (r, c) adopts from (r, c-1) then (r, c+1) ----
    mx, my = mid[0], mid[1]
    liveM, mkx, mky = live(mx), key_x(mx), key_y(my)
    lf = [_shift(p, -1, 1, f) for p, f in zip(mid, fills)]
    rt = [_shift(p, 1, 1, f) for p, f in zip(mid, fills)]
    kg0 = (live(lf[0]) & (cols >= 1) & (key_y(lf[1]) == rows)
           & (key_x(lf[0]) >= cols))
    kg1 = (live(rt[0]) & (cols <= gw - 2) & (key_y(rt[1]) == rows)
           & (key_x(rt[0]) <= cols))
    win = [torch.cat([a, b], dim=-1) for a, b in zip(lf, rt)]
    out_x, _ = _hole_fill(mid, win, torch.cat([kg0, kg1], dim=-1),
                          liveM & ((mky != rows) | (mkx == cols)), fills)

    # ---- X-retention: did column c-1 / c+1 adopt column c's mover? ----
    in_row = liveM & (mky == rows)
    l2x, l2y = _shift(mx, -2, 1, SENTINEL), _shift(my, -2, 1, SENTINEL)
    g0_of_l = (live(l2x) & (cols >= 2) & (key_y(l2y) == rows)
               & (key_x(l2x) >= cols - 1))
    into_l = in_row & (cols >= 1) & (mkx <= cols - 1)
    rank_l = (g0_of_l.sum(-1, keepdim=True)
              + torch.cumsum(into_l.to(torch.int32), -1) - 1)
    adopted_l = into_l & (rank_l < (~live(lf[0])).sum(-1, keepdim=True))
    into_r = in_row & (cols <= gw - 2) & (mkx >= cols + 1)
    rank_r = torch.cumsum(into_r.to(torch.int32), -1) - 1
    adopted_r = into_r & (rank_r < (~live(rt[0])).sum(-1, keepdim=True))
    retain = in_row & (mkx != cols) & ~(adopted_l | adopted_r)
    out = [torch.where(retain, m, o) for m, o in zip(mid, out_x)]
    counts = live(out[0]).sum(-1, dtype=torch.int32).reshape(R * gw)
    return out, counts


def _band_slab(planes, fills: tuple, lo2, lo1, hi1):
    """Per channel, the band's ``[R, gw, C]`` slab extended to ``[R + 3, gw, C]``:
    global rows row0-2 (x/y from ``lo2``; the value channels' row is never
    read and holds the fill), row0-1 (``lo1``), the slab, row0+R (``hi1``)."""
    out = []
    for c, (p, f) in enumerate(zip(planes, fills)):
        low = lo2[c] if c < 2 else torch.full_like(lo1[c], f)
        out.append(torch.cat([low[None], lo1[c][None], p, hi1[c][None]]))
    return out


def rebin_planes_plain(planes, spec: GridSpec, fills=None):
    """Plain PyTorch version of K1 over all cells at once."""
    fills = _fills(planes, fills)
    gw, C = spec.gw, spec.capacity
    rows = lambda n, f: torch.full((n, gw, C), f, dtype=torch.float32,
                                   device=planes[0].device)
    ext = [torch.cat([rows(2, f), p, rows(1, f)]) for p, f in zip(planes, fills)]
    return _rebin_rows_plain(ext, spec, fills, 0)


def rebin_planes_band_plain(planes, spec: GridSpec, fills, row0: int, lo2, lo1, hi1):
    """Plain PyTorch version of K7: K1's logic on the band's slab extended by
    its ghost rows, in global rows."""
    fills = _fills(planes, fills)
    return _rebin_rows_plain(_band_slab(planes, fills, lo2, lo1, hi1), spec, fills,
                             row0)


def _rebin_launch(inputs, spec: GridSpec, fills: tuple, row0: int, rows: int,
                  in_off: int):
    """Launch the rebin kernels on the own global rows [row0, row0 + rows) of
    ``inputs`` (global row r at input row r - row0 + in_off)."""
    k = len(inputs)
    if not 2 <= k <= 8:
        raise ValueError("the rebin kernel takes 2..8 channels")
    _lib.require_cuda_planes(*inputs)
    gw, C = spec.gw, spec.capacity
    dev = inputs[0].device
    mid = torch.empty((k, rows, gw, C), dtype=torch.float32, device=dev)
    out = [torch.empty((rows, gw, C), dtype=torch.float32, device=dev)
           for _ in range(k)]
    counts = torch.empty(rows * gw, dtype=torch.int32, device=dev)
    ptrs = ctypes.c_void_p * k
    lib = _lib.library()
    _lib.check("rps_rebin", lib.rps_rebin(
        ptrs(*(p.data_ptr() for p in inputs)), mid.data_ptr(),
        ptrs(*(p.data_ptr() for p in out)), counts.data_ptr(),
        (ctypes.c_float * k)(*fills), k, spec.gh, gw, C, row0, rows, in_off,
        spec.x_min, spec.y_min, spec.cell_width, spec.cell_size, _lib.stream()))
    return out, counts


def rebin_planes(planes, spec: GridSpec, fills=None, variant: int = 6):
    """Re-bin plane-resident channels by their (x, y) channels 0 and 1.

    ``planes``: k ``[gh, gw, C]`` f32 planes (dead slots carry SENTINEL in x/y);
    ``fills``: per-channel dead-slot fill (default SENTINEL for x/y, else 0).
    Returns ``(new_planes, counts)`` with counts ``[gh*gw]`` int32.  Launches K1
    for CUDA tensors; runs the plain version for CPU tensors."""
    require_variant_6(variant)
    if tuple(planes[0].shape) != (spec.gh, spec.gw, spec.capacity):
        raise ValueError(f"planes {tuple(planes[0].shape)} do not match {spec}")
    fills = _fills(planes, fills)
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_planes_plain(planes, spec, fills)
    out = _rebin_launch(planes, spec, fills, 0, spec.gh, 0)
    rebin_planes.launches += 1
    return out


rebin_planes.launches = 0


def rebin_planes_band(planes, spec: GridSpec, fills, row0: int, lo2, lo1, hi1):
    """Kernel K7: :func:`rebin_planes` on one band's ``[R, gw, C]`` slab of the
    grid ``spec``, whose first row is global row ``row0``.

    Ghost rows, each ``[gw, C]``: ``lo2`` (x, y) at global row row0-2, ``lo1``
    (every channel) at row0-1, ``hi1`` (every channel) at row0+R.  Returns the R
    own rows and ``[R*gw]`` counts, bit-identical to those rows of K1 on the
    whole grid.  Ghost rows outside the grid may hold anything: no decision
    reads them.  Launches K7 for CUDA tensors; runs the plain version for CPU
    tensors."""
    R, gw, C = planes[0].shape
    if (gw, C) != (spec.gw, spec.capacity) or not 0 <= row0 <= spec.gh - R:
        raise ValueError(f"a [{R}, {gw}, {C}] slab at row {row0} does not fit {spec}")
    if len(lo2) != 2 or len(lo1) != len(planes) or len(hi1) != len(planes):
        raise ValueError("lo2 holds x and y; lo1 and hi1 hold every channel")
    fills = _fills(planes, fills)
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_planes_band_plain(planes, spec, fills, row0, lo2, lo1, hi1)
    out = _rebin_launch(_band_slab(planes, fills, lo2, lo1, hi1), spec, fills, row0,
                        R, 2)
    rebin_planes_band.launches += 1
    return out


rebin_planes_band.launches = 0

