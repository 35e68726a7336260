"""Plane-resident rebin: the per-frame neighbour-structure rebuild without a sort.

Counterpart of ``rust_particle_system_tpu/ops/pallas/rebin.py``, every variant
of ``rebin_planes``:

* variant 6 (default), the lossless row-fused hole-fill: kernel K1
  (``csrc/rebin.cu``) replaces the Pallas ``_make_kernel_v6`` on the whole grid
  (:func:`rebin_planes`, JAX ``_rebin_v6``); kernel K7, the same CUDA kernel
  on one band's slab, its ghost rows read where they lie and its rows tested
  in global rows, replaces it as driven by ``_rebin_v6_band``
  (:func:`rebin_planes_band`, for the band-sharded mesh).  Asked for them
  (:func:`rebin_planes_walk`, one entry for both), K1 and K7 also write the
  walks' position planes, the defer mask of :func:`walk_positions` on their
  output; handed the state's raw planes and ``predict``, they apply gravity
  and the predict (:func:`predict_channels`) to each value as they load it;
* variants 4 (lossy) and 5 (lossless, bit-identical to 6), the separable
  hole-fill: two passes of kernel K9 (``csrc/rebin_pass.cu``,
  :func:`hole_fill_pass`, JAX ``_make_kernel_v4`` driven by
  ``_hole_fill_pass``), pass Y then pass X, each followed for variant 5 by
  the retention merge in torch (:func:`retention_merge`, XLA code in JAX);
* variants 2 and 3, the full-window compaction: kernel K12
  (``csrc/rebin_compact.cu``, :func:`rebin_compact`, JAX ``_make_kernel_v2``
  and ``_make_kernel_v3``, which compute the same function).

Lossless contract (variants 5 and 6, pinned bit-for-bit against the JAX
package by the tests): a cell's stayers keep their slots; movers whose
(clamped, one-cell) hop lands in a neighbour fill that neighbour's DEAD slots
in candidate order — pass Y takes row r-1 then row r+1, pass X column c-1
then column c+1, slot order within each; a mover that no neighbour adopts is
retained in its slot.  Nothing is ever dropped.  ``counts`` are the per-cell
live totals after both passes.  Variant 4 fills every slot that does not stay
and drops what finds no hole; variants 2/3 compact each cell's candidates to
its low slots and count them (counts may exceed C: the overflow is dropped).

K1 is one launch: a block owns a few adjacent columns of one row, keeps both
passes' decisions in shared memory (pass Y's result as one word a slot: the
input slot it holds and its class for pass X, never the values), and moves
each value once, from the input planes to its final slot; its ranks come
from warp ballots and popcounts instead of the TPU's triangular and one-hot
matmuls.  On the H100 its ranking's instructions and its reads of x/y from L2
bound it, not device memory (``profile_rebin.py``).  K9 ranks the same way, one
block per destination cell; K12 keys each slot once for a tile of adjacent
flat cells and ranks each cell with one warp (``profile_rebin.py --k12``).
"""

from __future__ import annotations

import torch

from ..grid import GridSpec, cell_index
from . import _lib

SENTINEL = 1.0e6  # dead-slot parking position
VARIANTS = (2, 3, 4, 5, 6)


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


def check_variant(variant: int) -> None:
    """The rebin variants of the JAX ``rebin_planes``: 2 and 3 (full-window
    compaction), 4 (lossy hole-fill), 5 and 6 (lossless hole-fill)."""
    if variant not in VARIANTS:
        raise ValueError(f"rebin variant {variant} is not one of {VARIANTS}")


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


def _hole_fill(own, win, keep, stay, fills, holes=None):
    """One hole-fill pass over every cell at once.

    ``own``: per-channel ``[..., C]``; ``win``: per-channel ``[..., 2C]``
    candidate windows; ``keep`` ``[..., 2C]`` (candidates that move here);
    ``stay`` ``[..., C]``; ``holes`` ``[..., C]`` (default: the dead own
    slots).  The candidate of window rank j fills the hole of rank j while
    j < #holes; stayers keep their slot and every other slot takes the fill.
    Returns (per-channel outputs, the adopted mask over the window)."""
    C = own[0].shape[-1]
    dead = ~(own[0] < 0.5 * SENTINEL) if holes is None else holes
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


def rebin_planes_plain(planes, spec: GridSpec, fills=None, variant: int = 6):
    """Plain PyTorch version of :func:`rebin_planes`: K1's over all cells at
    once (variant 6), K9's two passes with the retention merges (4, 5), K12's
    (2, 3)."""
    check_variant(variant)
    fills = _fills(planes, fills)
    if variant in (2, 3):
        return rebin_compact_plain(planes, spec, fills)
    if variant in (4, 5):
        return _rebin_separable(planes, spec, fills, variant == 5, hole_fill_pass_plain)
    gw, C = spec.gw, spec.capacity
    rows = lambda n, f: torch.full((n, gw, C), f, dtype=torch.float32,
                                   device=planes[0].device)
    ext = [torch.cat([rows(2, f), p, rows(1, f)]) for p, f in zip(planes, fills)]
    return _rebin_rows_plain(ext, spec, fills, 0)


def rebin_planes_band_plain(planes, spec: GridSpec, fills, row0: int, lo2, lo1, hi1):
    """Plain PyTorch version of K7: K1's logic on the band's slab extended by
    its ghost rows, in global rows."""
    fills = _fills(planes, fills)
    # Per channel, the slab extended by its ghost rows: global rows row0-2
    # (x/y; the value channels' row is never read and holds the fill), row0-1,
    # the slab, row0+R.
    ext = [torch.cat([(lo2[c] if c < 2 else torch.full_like(lo1[c], f))[None],
                      lo1[c][None], p, hi1[c][None]])
           for c, (p, f) in enumerate(zip(planes, fills))]
    return _rebin_rows_plain(ext, spec, fills, row0)


# ---------------- K9: one separable hole-fill pass (variants 4 and 5) ----------------


def _keys(x, y, spec: GridSpec):
    return (cell_index(x, spec.x_min, spec.cell_width, spec.gw),
            cell_index(y, spec.y_min, spec.cell_size, spec.gh))


def _flat_cells(nc: int, spec: GridSpec, row0: int, device):
    """(column, global row) of each flat cell, as ``[nc, 1]`` columns."""
    cell = torch.arange(nc, dtype=torch.int32, device=device)[:, None]
    return cell % spec.gw, cell // spec.gw + row0


def hole_fill_pass_plain(flats, spec: GridSpec, fills, shift: int, row_only: bool,
                         lossless: bool, ghosts=None, row0: int = 0):
    """Plain PyTorch version of K9 (JAX ``_hole_fill_pass`` + ``_make_kernel_v4``).

    The window of flat cell i is FLAT: group 0 = cell i - shift, group 1 =
    cell i + shift; past the ends, the ghost blocks ``ghosts[c] = (lo, hi)``
    (``[shift, C]`` each) or the fill."""
    nc, C = flats[0].shape
    live = lambda x: x < 0.5 * SENTINEL

    def side(c, d):
        p = flats[c]
        g = None if ghosts is None else ghosts[c][0 if d < 0 else 1]
        blk = (torch.full((abs(d), C), fills[c], dtype=p.dtype, device=p.device)
               if g is None else g.reshape(abs(d), C))
        return torch.cat([blk, p[:d]]) if d < 0 else torch.cat([p[d:], blk])

    win = [torch.cat([side(c, -shift), side(c, shift)], dim=1) for c in range(len(flats))]
    cx, cy = _flat_cells(nc, spec, row0, flats[0].device)
    kxw, kyw = _keys(win[0], win[1], spec)
    g0 = torch.arange(2 * C, device=cx.device) < C
    if not lossless:
        keep = kyw == cy
        if not row_only:
            keep = keep & (kxw == cx)
    elif row_only:  # the clamped hop toward the key row
        keep = torch.where(g0, kyw >= cy, kyw <= cy)
    else:  # rejects the flat shift's wrap at the row's ends
        keep = (kyw == cy) & torch.where(g0, (kxw >= cx) & (cx > 0),
                                         (kxw <= cx) & (cx < spec.gw - 1))
    keep = keep & live(win[0])
    olive = live(flats[0])
    kxo, kyo = _keys(flats[0], flats[1], spec)
    if row_only:
        stay = kyo == cy
    elif lossless:  # row-transit slots stay and retry rows next frame
        stay = (kyo != cy) | (kxo == cx)
    else:
        stay = (kyo == cy) & (kxo == cx)
    stay = stay & olive
    holes = ~olive if lossless else ~stay
    out, adopted = _hole_fill(flats, win, keep, stay, fills, holes)
    counts = stay.sum(-1) + torch.minimum(keep.sum(-1), holes.sum(-1))
    return out, counts.to(torch.int32), adopted if lossless else None


def retention_merge(in_flats, out_flats, adopted, spec: GridSpec, shift: int,
                    row_only: bool, row0: int = 0, extra_adopted=None):
    """The lossless rule after a pass (JAX ``_retention_merge``): a mover of
    this pass that no neighbour adopted keeps its source slot.

    ``adopted`` ``[nc, 2C]`` is in destination layout: group 0 lane j of cell
    i says that i adopted slot j of cell i - shift, group 1 slot j of cell
    i + shift.  ``extra_adopted`` ``[nc, C]`` adds adoptions made elsewhere
    (on the band-sharded mesh, by the neighbour bands), already in source
    layout."""
    nc, C = in_flats[0].shape
    took = torch.zeros((nc, C), dtype=torch.bool, device=adopted.device)
    took[:nc - shift] |= adopted[shift:, :C]
    took[shift:] |= adopted[:nc - shift, C:]
    if extra_adopted is not None:
        took |= extra_adopted.to(torch.bool)
    x, y = in_flats[0], in_flats[1]
    kx, ky = _keys(x, y, spec)
    cx, cy = _flat_cells(nc, spec, row0, x.device)
    mover = (ky != cy) if row_only else (ky == cy) & (kx != cx)
    retain = mover & (x < 0.5 * SENTINEL) & ~took
    return [torch.where(retain, i, o) for i, o in zip(in_flats, out_flats)]


# ---------------- K12: the full-window compaction (variants 2 and 3) ----------------


def rebin_compact_plain(planes, spec: GridSpec, fills):
    """Plain PyTorch version of K12: each cell's keyed candidates over its 9C
    window (JAX rebin.py:983-1006, flat shifts), compacted in window order."""
    fills = _fills(planes, fills)
    gh, gw, C = planes[0].shape
    nc = gh * gw
    dev = planes[0].device
    flats = [p.reshape(nc, C) for p in planes]
    cell = torch.arange(nc, device=dev)
    srcs = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            j = cell + dx
            f = j + dy * gw
            srcs.append(torch.where((j >= 0) & (j < nc) & (f >= 0) & (f < nc), f, -1))
    src = torch.stack(srcs, 1)[:, :, None]  # [nc, 9, 1]; -1: a dead lane

    def window(c):
        w = flats[c][src.clamp(min=0), torch.arange(C, device=dev)]  # [nc, 9, C]
        return torch.where(src >= 0, w, fills[c]).reshape(nc, 9 * C)

    win = [window(c) for c in range(len(planes))]
    cx, cy = _flat_cells(nc, spec, 0, dev)
    kx, ky = _keys(win[0], win[1], spec)
    keep = (win[0] < 0.5 * SENTINEL) & (kx == cx) & (ky == cy)
    rank = torch.cumsum(keep.to(torch.int32), -1) - 1
    dest = torch.where(keep & (rank < C), rank, C).long()  # slot C: a dump slot
    outs = []
    for w, f in zip(win, fills):
        o = torch.full((nc, C + 1), f, dtype=w.dtype, device=dev)
        o.scatter_(1, dest, w)
        outs.append(o[:, :C].reshape(gh, gw, C))
    return outs, keep.sum(-1, dtype=torch.int32)


def predict_channels(planes, predict) -> list:
    """Gravity + predict (compute_shader.wgsl:397-405) of the raw channels
    (px, py, vx, vy, ...) with ``predict = (dt, gdt)``, gdt the float32
    gravity * dt: the rebin's input channels [pred x, pred y, vx, vy, ...],
    dead slots parked, the channels after vy as they are."""
    dt, gdt = predict
    px, py, vx, vy = planes[:4]
    live = px < 0.5 * SENTINEL
    vxp = torch.where(live, vx, 0.0)
    vyp = torch.where(live, vy - gdt, 0.0)
    predx = torch.where(live, px + vxp * dt, SENTINEL)
    predy = torch.where(live, py + vyp * dt, SENTINEL)
    return [predx, predy, vxp, vyp, *planes[4:]]


def walk_positions(npx, npy, spec: GridSpec, row0: int = 0):
    """The walks' position planes: DEFERRED slots (live, but resident in another
    cell than their key) are parked at SENTINEL (resident.py:264-273).  The
    planes' first row is global row ``row0`` of ``spec`` (a band's slab on the
    band-sharded mesh, JAX plane_sharded.py:207-216)."""
    kx = cell_index(npx, spec.x_min, spec.cell_width, spec.gw)
    ky = cell_index(npy, spec.y_min, spec.cell_size, spec.gh)
    cellx = torch.arange(spec.gw, dtype=torch.int32, device=npx.device)[None, :, None]
    celly = (row0 + torch.arange(npx.shape[0], dtype=torch.int32,
                                 device=npx.device))[:, None, None]
    defer = (npx < 0.5 * SENTINEL) & ((kx != cellx) | (ky != celly))
    return torch.where(defer, SENTINEL, npx), torch.where(defer, SENTINEL, npy)


_rebin_kernel = _lib.kernel("rps_rebin")
_hole_fill_kernel = _lib.kernel("rps_hole_fill_pass")
_compact_kernel = _lib.kernel("rps_rebin_compact")


def _ptrs(tensors) -> tuple:
    return _lib.pad8([t.data_ptr() for t in tensors])


def _rebin_launch(planes, spec: GridSpec, fills: tuple, row0: int, ghosts=None,
                  walk: bool = False, predict=None):
    """Launch the rebin kernel on the ``[rows, gw, C]`` planes of global rows
    [row0, row0 + rows); ``ghosts``: K7's ghost rows ``(lo2, lo1, hi1)``, each
    a ``[gw, C]`` row (None for K1 on the whole grid, whose ghost rows lie
    outside it); ``predict``: ``(dt, gdt)`` to predict the planes at load
    (``rebin_tile<true>``), None to read them as given.  Returns (planes,
    counts), and with ``walk`` the walk planes (wx, wy) as a third item."""
    k = len(planes)
    if not 2 <= k <= 8:
        raise ValueError("the rebin kernel takes 2..8 channels")
    _lib.require_cuda_planes(*planes)
    rows, gw, C = planes[0].shape
    if ghosts is None:
        ghost_ptrs = (0,) * (2 + 2 * _lib.ARRAY)
    else:
        ghost_rows = (*ghosts[0], *ghosts[1], *ghosts[2])  # lo2 (x, y), lo1, hi1
        _lib.require_cuda(planes[0], *ghost_rows)
        if any(t.shape != (gw, C) for t in ghost_rows):
            raise ValueError(f"ghost rows must be [{gw}, {C}] each")
        ptrs = [t.data_ptr() for t in ghost_rows]
        ghost_ptrs = (*ptrs[:2], *_lib.pad8(ptrs[2:2 + k]), *_lib.pad8(ptrs[2 + k:]))
    out = _lib.empty_f32(k, planes[0].shape, planes[0])
    wxy = _lib.empty_f32(2, planes[0].shape, planes[0]) if walk else None
    walk_ptrs = (wxy[0].data_ptr(), wxy[1].data_ptr()) if walk else (0, 0)
    counts = torch.empty(rows * gw, dtype=torch.int32, device=planes[0].device)
    dt, gdt = (0.0, 0.0) if predict is None else predict
    _rebin_kernel(*_ptrs(planes), *ghost_ptrs, *_ptrs(out), *walk_ptrs, counts.data_ptr(),
                  *_lib.pad8(fills), k, spec.gh, gw, C, row0, rows, int(predict is not None),
                  spec.x_min, spec.y_min, spec.cell_width, spec.cell_size, dt, gdt)
    return (out, counts, tuple(wxy)) if walk else (out, counts)


def hole_fill_pass(flats, spec: GridSpec, fills, shift: int, row_only: bool,
                   lossless: bool, ghosts=None, row0: int = 0):
    """Kernel K9: one separable hole-fill pass over flat ``[nc, C]`` planes
    (the ``nc = R * gw`` cells of grid rows row0 .. row0 + R - 1 of ``spec``).

    ``shift``: gw for pass Y (``row_only``: the row test), 1 for pass X.
    ``lossless``: variant 5's rules (holes are the dead slots, clamped hops,
    the adoption mask returned) instead of variant 4's.  ``ghosts``: per
    channel ``(lo, hi)``, each ``[shift, C]`` (a neighbour band's edge row):
    the window lanes before the first and after the last cell; default, the
    fill.  Returns (k ``[nc, C]`` planes, ``[nc]`` int32 live counts, the
    ``[nc, 2C]`` bool adoption mask in destination layout, or None when
    lossy).  Launches K9 for CUDA tensors; runs the plain version for CPU
    tensors."""
    nc, C = flats[0].shape
    if C != spec.capacity or nc % spec.gw or not 0 <= row0 <= spec.gh - nc // spec.gw:
        raise ValueError(f"[{nc}, {C}] flat planes at row {row0} do not fit {spec}")
    if not 1 <= shift <= nc:
        raise ValueError(f"shift {shift} outside [1, {nc}]")
    if ghosts is not None and (len(ghosts) != len(flats) or any(
            g.numel() != shift * C for pair in ghosts for g in pair)):
        raise ValueError(f"ghosts: one (lo, hi) pair of [{shift}, {C}] per channel")
    fills = _fills(flats, fills)
    if _lib.dispatch(flats[0]) == "plain":
        return hole_fill_pass_plain(flats, spec, fills, shift, row_only, lossless,
                                    ghosts, row0)
    k = len(flats)
    if not 2 <= k <= 8:
        raise ValueError("the rebin kernels take 2..8 channels")
    _lib.require_cuda_planes(*flats)
    lo = hi = None
    if ghosts is not None:
        lo = [g[0].reshape(shift, C).contiguous() for g in ghosts]
        hi = [g[1].reshape(shift, C).contiguous() for g in ghosts]
        _lib.require_cuda_planes(flats[0][:shift], *lo, *hi)
    dev = flats[0].device
    out = _lib.empty_f32(k, (nc, C), flats[0])
    counts = torch.empty(nc, dtype=torch.int32, device=dev)
    adopted = (torch.empty(nc, 2 * C, dtype=torch.uint8, device=dev) if lossless
               else None)
    _hole_fill_kernel(*_ptrs(flats), *_ptrs(lo or ()), *_ptrs(hi or ()), *_ptrs(out),
                      counts.data_ptr(), 0 if adopted is None else adopted.data_ptr(),
                      *_lib.pad8(fills), k, nc, spec.gw, spec.gh, C, shift, row0, int(row_only),
                      int(lossless), spec.x_min, spec.y_min, spec.cell_width, spec.cell_size)
    hole_fill_pass.launches += 1
    return out, counts, None if adopted is None else adopted.view(torch.bool)


hole_fill_pass.launches = 0


def rebin_compact(planes, spec: GridSpec, fills=None):
    """Kernel K12: the full-window compaction of ``rebin_planes(variant=2|3)``.
    Returns (k ``[gh, gw, C]`` planes, ``[gh*gw]`` int32 candidate counts,
    which exceed C where candidates were dropped).  Launches K12 for CUDA
    tensors; runs the plain version for CPU tensors."""
    if tuple(planes[0].shape) != (spec.gh, spec.gw, spec.capacity):
        raise ValueError(f"planes {tuple(planes[0].shape)} do not match {spec}")
    fills = _fills(planes, fills)
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_compact_plain(planes, spec, fills)
    k = len(planes)
    if not 2 <= k <= 8:
        raise ValueError("the rebin kernels take 2..8 channels")
    _lib.require_cuda_planes(*planes)
    out = _lib.empty_f32(k, planes[0].shape, planes[0])
    counts = torch.empty(spec.num_cells, dtype=torch.int32, device=planes[0].device)
    _compact_kernel(*_ptrs(planes), *_ptrs(out), counts.data_ptr(), *_lib.pad8(fills), k,
                    spec.gh, spec.gw, spec.capacity, spec.x_min, spec.y_min, spec.cell_width,
                    spec.cell_size)
    rebin_compact.launches += 1
    return out, counts


rebin_compact.launches = 0


def _rebin_separable(planes, spec: GridSpec, fills: tuple, lossless: bool, hole_fill):
    """Variants 4 and 5: pass Y (``hole_fill``: K9 or its plain version; shift
    gw, the row test), pass X (shift 1), each followed, when ``lossless``, by
    the retention merge; the lossless counts are recounted from the merged
    planes (JAX rebin.py:961-981)."""
    gh, gw, C = planes[0].shape
    flats = [p.reshape(gh * gw, C) for p in planes]
    mid, _, adopted = hole_fill(flats, spec, fills, gw, True, lossless)
    if lossless:
        mid = retention_merge(flats, mid, adopted, spec, gw, True)
    out, counts, adopted = hole_fill(mid, spec, fills, 1, False, lossless)
    if lossless:
        out = retention_merge(mid, out, adopted, spec, 1, False)
        counts = (out[0] < 0.5 * SENTINEL).sum(-1, dtype=torch.int32)
    return [o.reshape(gh, gw, C) for o in out], counts


def rebin_planes(planes, spec: GridSpec, fills=None, variant: int = 6):
    """Re-bin plane-resident channels by their (x, y) channels 0 and 1.

    ``planes``: k ``[gh, gw, C]`` f32 planes (dead slots carry SENTINEL in x/y);
    ``fills``: per-channel dead-slot fill (default SENTINEL for x/y, else 0).
    Returns ``(new_planes, counts)`` with counts ``[gh*gw]`` int32: the live
    totals (variants 4-6) or the candidate totals (2, 3; see the module
    docstring).  Variant 6 launches K1, 4 and 5 two K9 passes, 2 and 3 K12 for
    CUDA tensors; each runs its plain version for CPU tensors.  Any other
    variant raises ValueError."""
    check_variant(variant)
    _check_grid(planes, spec)
    fills = _fills(planes, fills)
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_planes_plain(planes, spec, fills, variant)
    if variant in (2, 3):
        return rebin_compact(planes, spec, fills)
    if variant in (4, 5):
        return _rebin_separable(planes, spec, fills, variant == 5, hole_fill_pass)
    out = _rebin_launch(planes, spec, fills, 0)
    rebin_planes.launches += 1
    return out


rebin_planes.launches = 0


def _check_grid(planes, spec: GridSpec) -> None:
    if tuple(planes[0].shape) != (spec.gh, spec.gw, spec.capacity):
        raise ValueError(f"planes {tuple(planes[0].shape)} do not match {spec}")


def rebin_planes_band(planes, spec: GridSpec, fills, row0: int, lo2, lo1, hi1):
    """Kernel K7: :func:`rebin_planes` on one band's ``[R, gw, C]`` slab of the
    grid ``spec``, whose first row is global row ``row0``.

    Ghost rows, each ``[gw, C]`` (contiguous, on the slab's device: the kernel
    reads them where they lie): ``lo2`` (x, y) at global row row0-2, ``lo1``
    (every channel) at row0-1, ``hi1`` (every channel) at row0+R.  Returns the R
    own rows and ``[R*gw]`` counts, bit-identical to those rows of K1 on the
    whole grid.  Ghost rows outside the grid may hold anything: no decision
    reads them.  Launches K7 for CUDA tensors; runs the plain version for CPU
    tensors."""
    fills = _check_band(planes, spec, fills, row0, lo2, lo1, hi1)
    if _lib.dispatch(planes[0]) == "plain":
        return rebin_planes_band_plain(planes, spec, fills, row0, lo2, lo1, hi1)
    out = _rebin_launch(planes, spec, fills, row0, (lo2, lo1, hi1))
    rebin_planes_band.launches += 1
    return out


rebin_planes_band.launches = 0


def _check_band(planes, spec: GridSpec, fills, row0: int, lo2, lo1, hi1) -> tuple:
    """Raise unless the slab and its ghost rows fit ``spec``; the fills."""
    R, gw, C = planes[0].shape
    if (gw, C) != (spec.gw, spec.capacity) or not 0 <= row0 <= spec.gh - R:
        raise ValueError(f"a [{R}, {gw}, {C}] slab at row {row0} does not fit {spec}")
    if len(lo2) != 2 or len(lo1) != len(planes) or len(hi1) != len(planes):
        raise ValueError("lo2 holds x and y; lo1 and hi1 hold every channel")
    return _fills(planes, fills)


def rebin_planes_walk(planes, spec: GridSpec, fills=None, row0: int = 0, ghosts=None,
                      predict=None):
    """K1 (:func:`rebin_planes`, variant 6) on the whole grid, or with
    ``ghosts`` = ``(lo2, lo1, hi1)`` K7 (:func:`rebin_planes_band`) on the
    band's slab whose first row is global row ``row0``, that also writes the
    walks' position planes.  Returns ``(planes, counts, (wx, wy))``: (wx, wy)
    are :func:`walk_positions` of the output x/y, deferred slots parked at
    SENTINEL, which the kernel decides by its key cuts as it writes each
    slot; a band's are those rows of the whole grid's.

    ``predict`` = ``(dt, gdt)``: ``planes`` are the state's raw (px, py, vx,
    vy, ...) channels, and the kernel applies :func:`predict_channels` to
    each value of them it loads, rounded as the plain version rounds, so the
    output is that of the predicted channels bit for bit; the ghost rows come
    predicted.  None (the default): ``planes`` are the rebin's input as they
    are.  Counts its launches in ``rebin_planes_band.launches`` (K7's) with
    ``ghosts``, else in ``rebin_planes.launches`` (K1's).  Runs
    :func:`predict_channels`, the plain rebin then :func:`walk_positions` for
    CPU tensors."""
    if predict is not None and len(planes) < 4:
        raise ValueError("the predict at load reads px, py, vx and vy: 4 channels or more")
    if ghosts is None:
        _check_grid(planes, spec)
        if row0:
            raise ValueError(f"row {row0}: the whole grid starts at row 0; a band "
                             "passes its ghost rows")
        fills = _fills(planes, fills)
    else:
        fills = _check_band(planes, spec, fills, row0, *ghosts)
    if _lib.dispatch(planes[0]) == "plain":
        if predict is not None:
            planes = predict_channels(planes, predict)
        out, counts = (rebin_planes_plain(planes, spec, fills) if ghosts is None
                       else rebin_planes_band_plain(planes, spec, fills, row0, *ghosts))
        return out, counts, walk_positions(out[0], out[1], spec, row0)
    out = _rebin_launch(planes, spec, fills, row0, ghosts, walk=True, predict=predict)
    (rebin_planes if ghosts is None else rebin_planes_band).launches += 1
    return out
