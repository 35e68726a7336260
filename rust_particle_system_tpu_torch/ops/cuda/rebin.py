"""Plane-resident rebin: the per-frame neighbour-structure rebuild without a sort.

Counterpart of ``rust_particle_system_tpu/ops/pallas/rebin.py``, variant 6 (the
lossless row-fused hole-fill; bit-identical to variant 5) only.  Kernel K1
(``csrc/rebin.cu``) replaces the Pallas ``_make_kernel_v6``.

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


def _default_fills(k: int) -> tuple:
    return tuple(SENTINEL if c < 2 else 0.0 for c in range(k))


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


def rebin_planes_plain(planes, spec: GridSpec, fills=None):
    """Plain PyTorch version of K1 over all cells at once."""
    gh, gw, C = planes[0].shape
    k = len(planes)
    fills = _default_fills(k) if fills is None else tuple(float(f) for f in fills)
    dev = planes[0].device
    rows = torch.arange(gh, device=dev).view(gh, 1, 1)
    cols = torch.arange(gw, device=dev).view(1, gw, 1)
    live = lambda x: x < 0.5 * SENTINEL
    key_x = lambda x: cell_index(x, spec.x_min, spec.cell_width, gw)
    key_y = lambda y: cell_index(y, spec.y_min, spec.cell_size, gh)

    # ---- pass Y: cell (r, c) adopts from (r-1, c) then (r+1, c) ----
    x0, y0 = planes[0], planes[1]
    live0, ky0 = live(x0), key_y(y0)
    up = [_shift(p, -1, 0, f) for p, f in zip(planes, fills)]
    dn = [_shift(p, 1, 0, f) for p, f in zip(planes, fills)]
    keep_up = live(up[0]) & (rows >= 1) & (key_y(up[1]) >= rows)
    keep_dn = live(dn[0]) & (rows <= gh - 2) & (key_y(dn[1]) <= rows)
    win = [torch.cat([u, d], dim=-1) for u, d in zip(up, dn)]
    out_y, _ = _hole_fill(planes, win, torch.cat([keep_up, keep_dn], dim=-1),
                          live0 & (ky0 == rows), fills)

    # ---- Y-retention: did row r-1 / r+1 adopt row r's mover? ----
    x2, y2 = _shift(x0, -2, 0, SENTINEL), _shift(y0, -2, 0, SENTINEL)
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
    counts = live(out[0]).sum(-1, dtype=torch.int32).reshape(gh * gw)
    return out, counts


def rebin_planes(planes, spec: GridSpec, fills=None, variant: int = 6):
    """Re-bin plane-resident channels by their (x, y) channels 0 and 1.

    ``planes``: k ``[gh, gw, C]`` f32 planes (dead slots carry SENTINEL in x/y);
    ``fills``: per-channel dead-slot fill (default SENTINEL for x/y, else 0).
    Returns ``(new_planes, counts)`` with counts ``[gh*gw]`` int32.  Launches K1
    for CUDA tensors; runs the plain version for CPU tensors."""
    if variant != 6:
        raise NotImplementedError(
            f"rebin variant {variant} is not ported; the port implements the "
            f"lossless variant 6 (bit-identical to 5)")
    gh, gw, C = planes[0].shape
    if (gh, gw, C) != (spec.gh, spec.gw, spec.capacity):
        raise ValueError(f"planes {tuple(planes[0].shape)} do not match {spec}")
    k = len(planes)
    fills = _default_fills(k) if fills is None else tuple(float(f) for f in fills)
    # A filled slot must read as dead: the counts (and the JAX kernel's
    # air-row skip, which writes counts of 0) rely on it.
    if not fills[0] >= 0.5 * SENTINEL:
        raise ValueError("fills[0] must park dead slots at SENTINEL")
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_planes_plain(planes, spec, fills)
    if not 2 <= k <= 8:
        raise ValueError("the rebin kernel takes 2..8 channels")
    _lib.require_cuda_planes(*planes)
    dev = planes[0].device
    mid = torch.empty((k, gh, gw, C), dtype=torch.float32, device=dev)
    out = [torch.empty_like(p) for p in planes]
    counts = torch.empty(gh * gw, dtype=torch.int32, device=dev)
    ptrs = ctypes.c_void_p * k
    lib = _lib.library()
    _lib.check("rps_rebin", lib.rps_rebin(
        ptrs(*(p.data_ptr() for p in planes)), mid.data_ptr(),
        ptrs(*(p.data_ptr() for p in out)), counts.data_ptr(),
        (ctypes.c_float * k)(*fills), k, gh, gw, C, spec.x_min, spec.y_min,
        spec.cell_width, spec.cell_size, _lib.stream()))
    rebin_planes.launches += 1
    return out, counts


rebin_planes.launches = 0
