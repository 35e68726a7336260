"""SPH neighbourhood walks over ``[gh, gw, C]`` cell planes.

Counterpart of ``rust_particle_system_tpu/ops/pallas/sph.py``, for the classic
one-cell-per-slot-row layout and the pair-packed one:

* :func:`density_planes` — kernel K2 (``csrc/sph.cu``), replacing the Pallas
  ``_make_seg_kernel`` + ``_density_update``: (rho, rhon) = norms x (sum v^2,
  sum v^3) over the 3x3 cells, v = max(h - d, 0), self included.
* :func:`density_pressure_planes` — kernel K2 with its pressure epilogue:
  the force walk's per-slot terms (P1, NPo, NPn) of :func:`pressure_terms`,
  computed from each slot's two sums in registers, op by op in torch's
  order, so bit for bit :func:`pressure_terms` of :func:`density_planes`
  (JAX computes the terms outside Pallas, after ``_density_update``).  The
  frame walks through it; :func:`pressure_terms` is its plain version's
  second half.
* :func:`force_planes_integrated` — kernel K3, replacing ``_make_seg_kernel`` +
  ``_force_update`` + ``_force_finalize_integrated``: the fused pressure,
  near-pressure and viscosity walk with the frame tail (velocity combine,
  deferred restore, Euler, bounce, park) in its epilogue.
* :func:`force_planes` — kernel K3b, replacing ``_make_seg_kernel`` +
  ``_force_update`` + ``_force_finalize``: the same walk with the raw-sum
  epilogue (fx, fy, fvx, fvy), for the unfused tail (``fuse_tail=False``).
* :func:`density_pairs`, :func:`density_pressure_pairs`,
  :func:`force_pairs_integrated`, :func:`force_pairs` — kernel K6, replacing
  ``_make_seg_kernel`` with ``n_dx=2`` (the pair-packed layout,
  ``sph_step.py:95-153``): the same walks and outputs, launched
  as the strip walks of K2/K3/K3b on the pair-packed planes (a strip holds
  whole pairs), so their outputs are K2's/K3's/K3b's bit for bit.  Their
  plain versions walk the window the TPU walked, B[p] and B[p+1] (cells
  2p-1 .. 2p+2, rows r-1 .. r+1), whose extra column adds exact zeros.

Ghost rows: with ``ghost=True`` the neighbour-side planes are a band's slab
with one ghost row on each side (``[R + 2, gw, C]``, the rows of the
neighbour bands on the band-sharded mesh, the JAX walks' ``halo``); the walk
serves the R own rows only, and the own-side planes (``NPo``, ``npx``,
``npy``) and the outputs are ``[R, gw, C]``.

Conventions (as in JAX): dead slots and deferred slots carry position
SENTINEL in the walk planes, so every pair with them weighs exactly 0.  Both
walks give 0 accumulators to slots whose walk position is parked (the JAX
kernel leaves finite garbage there or zeroes a gated chunk; those values are
never read back).

The walks are arithmetic-bound on the H100 (an rsqrt per force pair).  The
kernels stage only the live neighbour slots in shared memory, so a pair loop
runs over live neighbours instead of the TPU's dense, lane-padded 9C window.
The walks give a thread to each live particle of a strip of cells of one row
(the strip, the block and the tile of staged neighbours are fixed in
``csrc/sph.cu``).  The plain versions
below evaluate the dense window in row chunks so that they fit in device
memory at the main-path size.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import kernels as K
from ...core.params import SimParams, f32, f32_mul
from . import _lib
from .rebin import SENTINEL

EPS_DIST = 1e-4  # direction guard (compute_shader.wgsl:305)
EPS2 = float(np.float32(EPS_DIST) ** 2)  # float32(1e-4)^2 in f32, as JAX forms it

# Plain versions: pair elements per row chunk (about 128 MB per f32 temporary).
PLAIN_CHUNK_ELEMS = 1 << 25

MAX_CAPACITY = 1024  # the largest C the walks take (csrc/sph.cu::kMaxC)


def _live(x):
    return x < 0.5 * SENTINEL


def _window_columns(gw: int, pair: bool, device) -> torch.Tensor:
    """``[gw, nx]`` padded column indices (2 fill columns on each side) of the
    window each own cell walks: columns c-1..c+1, or for the pair-packed
    layout columns 2p-1..2p+2 of cell c's pair p = c // 2."""
    c = torch.arange(gw, device=device)
    if pair:
        return (2 * (c // 2) + 1)[:, None] + torch.arange(4, device=device)
    return (c + 1)[:, None] + torch.arange(3, device=device)


def _windows(planes_fills, r0: int, r1: int, gw: int, pair: bool = False):
    """Per plane: the neighbour window of rows r0..r1 as ``[R, gw, W, C]``: the
    3x3 cells (W = 9) or the pair-packed 3x4 (W = 12), offsets row-major,
    ghost cells at the channel fill."""
    out = []
    for p, fill in planes_fills:
        gh, _, C = p.shape
        cols = _window_columns(gw, pair, p.device)
        lo, hi = max(r0 - 1, 0), min(r1 + 1, gh)
        pad = torch.full((r1 - r0 + 2, gw + 4, C), fill, dtype=p.dtype,
                         device=p.device)
        pad[lo - (r0 - 1): hi - (r0 - 1), 2: gw + 2] = p[lo:hi]
        out.append(torch.cat([pad[dy: dy + r1 - r0][:, cols] for dy in range(3)],
                             dim=2))
    return out


def _chunk_rows(gw: int, C: int, pair: bool) -> int:
    return max(1, PLAIN_CHUNK_ELEMS // (gw * C * (12 if pair else 9) * C))


def _live_slot_bound(px, r0: int, r1: int) -> int:
    """1 + the highest slot index that is live in rows r0-1..r1 (0 if none).

    Slots above it are parked in every own and neighbour cell of the chunk, so
    they add exactly 0 to every sum: the plain walks drop them (a host read per
    chunk; the plain versions are references, not the hot path)."""
    rows = px[max(r0 - 1, 0): r1 + 1]
    any_live = _live(rows).flatten(0, 1).any(dim=0)
    idx = torch.nonzero(any_live)
    return int(idx.max()) + 1 if idx.numel() else 0


def _own_rows(gh: int, ghost: bool) -> tuple:
    """The own rows [lo, hi) of neighbour planes of ``gh`` rows."""
    return (1, gh - 1) if ghost else (0, gh)


def density_planes_plain(px, py, h: float, dnorm: float, nnorm: float,
                         pair: bool = False, ghost: bool = False):
    """Plain PyTorch version of K2 (of K6's density walk with ``pair``)."""
    gh, gw, C = px.shape
    lo, hi = _own_rows(gh, ghost)
    rho = torch.zeros((hi - lo, gw, C), dtype=px.dtype, device=px.device)
    rhon = torch.zeros_like(rho)
    step = _chunk_rows(gw, C, pair)
    for r0 in range(lo, hi, step):
        r1 = min(hi, r0 + step)
        c = _live_slot_bound(px, r0, r1)
        if c == 0:
            continue
        pxc, pyc = px[..., :c], py[..., :c]
        nx, ny = _windows([(pxc, SENTINEL), (pyc, SENTINEL)], r0, r1, gw, pair)
        ox, oy = pxc[r0:r1, :, :, None, None], pyc[r0:r1, :, :, None, None]
        dx = nx[:, :, None] - ox  # [R, gw, c(own), W, c(nbr)]
        dy = ny[:, :, None] - oy
        v = (h - torch.sqrt(dx * dx + dy * dy)).clamp_min(0.0)
        vv = v * v
        own_live = _live(pxc[r0:r1])
        rho[r0 - lo:r1 - lo, :, :c] = torch.where(own_live, dnorm * vv.sum(-2).sum(-1),
                                                  0.0)
        rhon[r0 - lo:r1 - lo, :, :c] = torch.where(own_live,
                                                   nnorm * (vv * v).sum(-2).sum(-1), 0.0)
    return rho, rhon


def _check_shapes(nbr, own, ghost: bool) -> None:
    """Neighbour-side planes of one shape ``[gh, gw, C]`` (gh >= 3 with ghost
    rows); own-side planes ``[R, gw, C]`` for the R own rows."""
    shape = nbr[0].shape
    gh, gw, C = shape
    r0, r1 = _own_rows(gh, ghost)
    if r1 <= r0 or any(t.shape != shape for t in nbr):
        raise ValueError(f"neighbour planes {[tuple(t.shape) for t in nbr]} "
                         f"(ghost rows: {ghost})")
    own_shape = (r1 - r0, gw, C)
    if any(t.shape != own_shape for t in own):
        raise ValueError(f"own-side planes {[tuple(t.shape) for t in own]} do not fit "
                         f"neighbour planes {tuple(nbr[0].shape)} (ghost rows: {ghost})")


_density = _lib.kernel("rps_density")
_force_integrated = _lib.kernel("rps_force_integrated")
_force = _lib.kernel("rps_force")
_pair_density = _lib.kernel("rps_pair_density")
_pair_force_integrated = _lib.kernel("rps_pair_force_integrated")
_pair_force = _lib.kernel("rps_pair_force")
_density_pressure = _lib.kernel("rps_density_pressure")
_pair_density_pressure = _lib.kernel("rps_pair_density_pressure")


def _launch(launch, nbr, own, n_out: int, ghost: bool, *scalars):
    """Launch a walk kernel: neighbour-side planes ``nbr`` ``[gh, gw, C]``
    (with a ghost row on each side if ``ghost``), own-side planes ``own`` (their
    shapes checked by :func:`_check_shapes`) and ``n_out`` new output planes
    ``[R, gw, C]``, then the grid shape and ``scalars`` by value.  Raises
    ValueError for a C outside 1..MAX_CAPACITY."""
    gh, gw, C = nbr[0].shape
    if not 1 <= C <= MAX_CAPACITY:
        raise ValueError(f"the strip walks take 1 <= C <= {MAX_CAPACITY} slots a cell, got {C}")
    _lib.require_cuda(*nbr, *own)
    r0, r1 = _own_rows(gh, ghost)
    outs = _lib.empty_f32(n_out, (r1 - r0, gw, C), own[0] if own else nbr[0])
    launch(*[t.data_ptr() for t in (*nbr, *own, *outs)], gh, r0, r1 - r0, gw, C, *scalars)
    return tuple(outs)


def density_scalars(params: SimParams) -> tuple:
    """(h, density norm, near-density norm)."""
    return (params.smoothing_radius, params.density_kernel_norm,
            params.near_density_kernel_norm)


def density_planes(px, py, params: SimParams, ghost: bool = False):
    """(rho, rhon) ``[gh, gw, C]`` from walk position planes (the own rows
    only with ``ghost``).  Launches K2 for CUDA tensors; runs the plain version
    for CPU tensors."""
    scal = density_scalars(params)
    _check_shapes((px, py), (), ghost)
    if _lib.dispatch(px) == "plain":
        return density_planes_plain(px, py, *scal, ghost=ghost)
    out = _launch(_density, (px, py), (), 2, ghost, *scal)
    density_planes.launches += 1
    return out


density_planes.launches = 0


def density_pairs(px, py, params: SimParams, ghost: bool = False):
    """:func:`density_planes` in the pair-packed layout: launches K6's density
    walk for CUDA tensors; runs its plain version for CPU tensors."""
    scal = density_scalars(params)
    _check_shapes((px, py), (), ghost)
    if _lib.dispatch(px) == "plain":
        return density_planes_plain(px, py, *scal, pair=True, ghost=ghost)
    out = _launch(_pair_density, (px, py), (), 2, ghost, *scal)
    density_pairs.launches += 1
    return out


density_pairs.launches = 0


def pressure_scalars(params: SimParams) -> tuple:
    """(target density, pressure multiplier, near-density multiplier, alpha,
    beta) with alpha = -2 density norm, beta = -3 near-density norm formed in
    f32."""
    return (params.target_density, params.pressure_multiplier,
            params.near_density_multiplier, f32(-2.0 * params.density_kernel_norm),
            f32(-3.0 * params.near_density_kernel_norm))


def pressure_terms(rho, rhon, params: SimParams):
    """Per-slot pressure terms pre-scaled by the pair-loop scalars:
    (alpha p / rho^2, beta np / rho^2, beta np / (rho rhon)), guarded for
    empties.  K2's pressure epilogue rounds the same operations in the same
    order (``csrc/sph.cu::pressure_terms``)."""
    target, pmult, nmult, alpha, beta = pressure_scalars(params)
    rho_safe = torch.where(rho > 0, rho, 1.0)
    rhon_safe = torch.where(rhon > 0, rhon, 1.0)
    inv_rho2 = 1.0 / (rho_safe * rho_safe)
    p = (rho - target) * pmult
    np_ = rhon * nmult
    return (
        alpha * (p * inv_rho2),
        beta * (np_ * inv_rho2),
        beta * (np_ / (rho_safe * rhon_safe)),
    )


def density_pressure_planes(px, py, params: SimParams, ghost: bool = False):
    """(P1, NPo, NPn) ``[gh, gw, C]`` from walk position planes (the own rows
    only with ``ghost``): :func:`pressure_terms` of :func:`density_planes`,
    bit for bit.  Launches K2 with its pressure epilogue for CUDA tensors;
    runs the plain composition for CPU tensors."""
    scal = density_scalars(params)
    _check_shapes((px, py), (), ghost)
    if _lib.dispatch(px) == "plain":
        return pressure_terms(*density_planes_plain(px, py, *scal, ghost=ghost), params)
    out = _launch(_density_pressure, (px, py), (), 3, ghost, *scal, *pressure_scalars(params))
    density_pressure_planes.launches += 1
    return out


density_pressure_planes.launches = 0


def density_pressure_pairs(px, py, params: SimParams, ghost: bool = False):
    """:func:`density_pressure_planes` in the pair-packed layout: launches
    K6's density walk with the pressure epilogue for CUDA tensors; runs the
    plain composition for CPU tensors."""
    scal = density_scalars(params)
    _check_shapes((px, py), (), ghost)
    if _lib.dispatch(px) == "plain":
        return pressure_terms(*density_planes_plain(px, py, *scal, pair=True, ghost=ghost),
                              params)
    out = _launch(_pair_density_pressure, (px, py), (), 3, ghost, *scal,
                  *pressure_scalars(params))
    density_pressure_pairs.launches += 1
    return out


density_pressure_pairs.launches = 0


def force_scalars(params: SimParams) -> tuple:
    """(h, eps2, dt, vscale, x_min, x_max, y_min, y_max, damping), with
    vscale = viscosity norm x strength x dt formed in f32 as JAX does."""
    vscale = f32_mul(f32_mul(params.viscosity_kernel_norm,
                             params.viscosity_strength), params.dt)
    return (params.smoothing_radius, EPS2, params.dt, vscale, *params.bounds,
            params.damping_factor)


def finalize_plain(accs, own, scal):
    """The raw epilogue (sph.py::_force_finalize): subtract the closed-form
    self term, combine the viscosity sums.  Returns (fx, fy, fvx, fvy)."""
    fx, fy, S, Sx, Sy = accs
    h = scal[0]
    _, _, oP1, oNPn, ovx, ovy, oNPo = own[:7]
    fy = fy - ((oP1 + oP1) * h + (oNPo + oNPn) * (h * h))
    return fx, fy, Sx - ovx * S, Sy - ovy * S


def tail_plain(accs, own, scal):
    """The integrated epilogue (raw epilogue, velocity combine, deferred
    restore, Euler, bounce, park) on per-slot tensors; ``own`` = (px, py, P1,
    NPn, vx, vy, NPo, npx, npy) walk/own values."""
    _, _, dt, vscale, x_min, x_max, y_min, y_max, damp = scal
    ox, ovx, ovy, onpx, onpy = own[0], own[4], own[5], own[7], own[8]
    fx, fy, fvx, fvy = finalize_plain(accs, own, scal)
    nvx = ovx + fx * dt + fvx * vscale
    nvy = ovy + fy * dt + fvy * vscale
    live = _live(onpx)
    defer = ~_live(ox) & live
    nvx = torch.where(defer, ovx, nvx)
    nvy = torch.where(defer, ovy, nvy)
    x2, nvx = K.bounce_axis(onpx + (nvx - ovx) * dt, nvx, x_min, x_max, damp)
    y2, nvy = K.bounce_axis(onpy + (nvy - ovy) * dt, nvy, y_min, y_max, damp)
    return (torch.where(live, x2, SENTINEL), torch.where(live, y2, SENTINEL),
            torch.where(live, nvx, 0.0), torch.where(live, nvy, 0.0))


def _force_walk_plain(planes, scal: tuple, epilogue, pair: bool, ghost: bool):
    """Plain PyTorch version of the K3/K3b/K6 force walk: the five pair sums
    over the dense window in row chunks, then ``epilogue(accs, own, scal)`` per
    chunk.  ``planes`` = (px, py, P1, NPn, vx, vy, NPo, *own-only extras): the
    first six on the neighbour side, the rest own-side."""
    px, py, P1, NPn, vx, vy = planes[:6]
    h, eps2 = scal[0], scal[1]
    gh, gw, C = px.shape
    lo, hi = _own_rows(gh, ghost)
    outs = [torch.empty((hi - lo, gw, C), dtype=px.dtype, device=px.device)
            for _ in range(4)]
    step = _chunk_rows(gw, C, pair)
    for r0 in range(lo, hi, step):
        r1 = min(hi, r0 + step)
        own = ([t[r0:r1] for t in planes[:6]]
               + [t[r0 - lo:r1 - lo] for t in planes[6:]])
        accs = [torch.zeros_like(own[0]) for _ in range(5)]
        c = _live_slot_bound(px, r0, r1)
        if c:
            nx, ny, nP1, nNPn, nvx, nvy = _windows(
                [(px[..., :c], SENTINEL), (py[..., :c], SENTINEL), (P1[..., :c], 0.0),
                 (NPn[..., :c], 0.0), (vx[..., :c], 0.0), (vy[..., :c], 0.0)],
                r0, r1, gw, pair)
            e = lambda t: t[:, :, :c, None, None]
            n = lambda t: t[:, :, None]
            dx = n(nx) - e(own[0])
            dy = n(ny) - e(own[1])
            d2 = dx * dx + dy * dy
            near0 = d2 <= eps2
            inv_d = torch.where(near0, 0.0, torch.rsqrt(d2))
            v = (h - d2 * inv_d).clamp_min(0.0)
            mag = (e(own[2]) + n(nP1)) * v + (e(own[6]) + n(nNPn)) * (v * v)
            m = mag * inv_d
            u = (h * h - d2).clamp_min(0.0)
            u3 = u * u * u
            walk_live = _live(own[0][..., :c])
            sums = (dx * m, dy * m + torch.where(near0, mag, 0.0), u3,
                    n(nvx) * u3, n(nvy) * u3)
            for a, t in zip(accs, sums):
                a[..., :c] = torch.where(walk_live, t.sum(-2).sum(-1), 0.0)
        for o, t in zip(outs, epilogue(accs, own, scal)):
            o[r0 - lo:r1 - lo] = t
    return tuple(outs)


def force_planes_integrated_plain(px, py, P1, NPn, vx, vy, NPo, npx, npy,
                                  scal: tuple, pair: bool = False, ghost: bool = False):
    """Plain PyTorch version of K3 (of K6's fused walk with ``pair``)."""
    return _force_walk_plain((px, py, P1, NPn, vx, vy, NPo, npx, npy), scal,
                             tail_plain, pair, ghost)


def force_planes_plain(px, py, P1, NPn, vx, vy, NPo, scal: tuple,
                       pair: bool = False, ghost: bool = False):
    """Plain PyTorch version of K3b (of K6's raw walk with ``pair``)."""
    return _force_walk_plain((px, py, P1, NPn, vx, vy, NPo), scal, finalize_plain,
                             pair, ghost)


def force_planes_integrated(px, py, P1, NPn, vx, vy, NPo, npx, npy,
                            params: SimParams, ghost: bool = False):
    """The fused pressure + viscosity walk with the frame tail in its epilogue.

    Walk planes ``px, py`` (deferred slots parked at SENTINEL), per-slot terms
    ``P1, NPn`` and velocities ``vx, vy`` on the neighbour side; ``NPo`` and the
    true predicted positions ``npx, npy`` on the own side.  Returns the FINAL
    (px, py, vx, vy) planes.  Launches K3 for CUDA tensors; runs the plain
    version for CPU tensors."""
    scal = force_scalars(params)
    _check_shapes((px, py, P1, NPn, vx, vy), (NPo, npx, npy), ghost)
    if _lib.dispatch(px) == "plain":
        return force_planes_integrated_plain(px, py, P1, NPn, vx, vy, NPo, npx, npy,
                                             scal, ghost=ghost)
    out = _launch(_force_integrated, (px, py, P1, NPn, vx, vy), (NPo, npx, npy), 4,
                  ghost, *scal)
    force_planes_integrated.launches += 1
    return out


force_planes_integrated.launches = 0


def force_pairs_integrated(px, py, P1, NPn, vx, vy, NPo, npx, npy,
                           params: SimParams, ghost: bool = False):
    """:func:`force_planes_integrated` in the pair-packed layout: launches K6's
    fused walk for CUDA tensors; runs its plain version for CPU tensors."""
    scal = force_scalars(params)
    _check_shapes((px, py, P1, NPn, vx, vy), (NPo, npx, npy), ghost)
    if _lib.dispatch(px) == "plain":
        return force_planes_integrated_plain(px, py, P1, NPn, vx, vy, NPo, npx, npy,
                                             scal, pair=True, ghost=ghost)
    out = _launch(_pair_force_integrated, (px, py, P1, NPn, vx, vy), (NPo, npx, npy),
                  4, ghost, *scal)
    force_pairs_integrated.launches += 1
    return out


force_pairs_integrated.launches = 0


def force_planes(px, py, P1, NPn, vx, vy, NPo, params: SimParams, ghost: bool = False):
    """The pressure + viscosity walk with the raw-sum epilogue: (fx, fy, fvx,
    fvy) planes, fvx/fvy unscaled (the caller applies the viscosity scale).
    Same inputs as :func:`force_planes_integrated` without ``npx, npy``.
    Launches K3b for CUDA tensors; runs the plain version for CPU tensors."""
    scal = force_scalars(params)
    _check_shapes((px, py, P1, NPn, vx, vy), (NPo,), ghost)
    if _lib.dispatch(px) == "plain":
        return force_planes_plain(px, py, P1, NPn, vx, vy, NPo, scal, ghost=ghost)
    out = _launch(_force, (px, py, P1, NPn, vx, vy), (NPo,), 4, ghost, *scal[:2])
    force_planes.launches += 1
    return out


force_planes.launches = 0


def force_pairs(px, py, P1, NPn, vx, vy, NPo, params: SimParams, ghost: bool = False):
    """:func:`force_planes` in the pair-packed layout: launches K6's raw walk
    for CUDA tensors; runs its plain version for CPU tensors."""
    scal = force_scalars(params)
    _check_shapes((px, py, P1, NPn, vx, vy), (NPo,), ghost)
    if _lib.dispatch(px) == "plain":
        return force_planes_plain(px, py, P1, NPn, vx, vy, NPo, scal, pair=True,
                                  ghost=ghost)
    out = _launch(_pair_force, (px, py, P1, NPn, vx, vy), (NPo,), 4, ghost, *scal[:2])
    force_pairs.launches += 1
    return out


force_pairs.launches = 0
