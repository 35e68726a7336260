"""The fast mode's per-cell stages: kernels K14a (moments) and K14c
(evaluation) and their plain PyTorch versions.

Counterpart of ``protos/mxu_fast_forces.py`` stage A (``make_moment_kernel``,
driven by ``moments``) and stage C (``make_eval_kernel``, driven by
``evaluate``).  Each slot of cell (cy, cx) has cell-local coordinates

    u = 2 (x - x_min - cx h) / h - 1,   v = 2 (y - y_min - cy h) / h - 1

(0 on dead slots) and the Chebyshev values T_0..T_deg of each (T_0 = 1,
T_1 = t, T_k = 2t T_{k-1} - T_{k-2}).  Stage A writes, per cell and weight
channel c, ``M[c, 16a + b] = sum_slots w_c T_a(u) T_b(v)`` (0 where a or b
exceeds deg); stage C reads, per cell and output pair p, ``L[p, 16a + b]``
and gives each live slot ``sum_a T_a(u) sum_b L[p, a, b] T_b(v)`` (0 on dead
slots).  The [16, 16] block per (cell, channel) is the JAX layout
(``BPAD``), so ``transfers`` (plain ``torch.matmul``) sees the same tensors.

The plain versions repeat JAX's recurrences (``_cheb_cols``) and its ``u``,
``v`` formulas op for op; the sums over slots and over ``b`` go to
``torch.bmm``.  :func:`moments` and :func:`evaluate` launch the kernels
(``csrc/fast_forces.cu``) for CUDA tensors and run the plain versions for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid import GridSpec
from . import _lib

SENT = 1.0e6  # dead slots: x = y = SENT; live <=> x < 0.5 * SENT
BPAD = 16  # (a, b) stored as [16, 16] blocks: 256 values per (cell, channel)
MAX_DEG = BPAD - 1
MAX_WEIGHTS = 4  # K14a's weight planes (the fast mode's passes use 1 and 4)
MAX_PAIRS = 8  # K14c's transfer pairs (the passes use 1 and 7)


def check_deg(deg: int) -> int:
    """NB = deg + 1 Chebyshev terms, 1 <= deg <= 15 (they fill one [16, 16]
    block); anything else raises ValueError."""
    if not 1 <= int(deg) <= MAX_DEG:
        raise ValueError(f"deg must lie in 1..{MAX_DEG}, got {deg}")
    return int(deg) + 1


def cheb_cols(t: torch.Tensor, nb: int) -> list:
    """The ``nb`` Chebyshev columns T_k(t), in JAX's order of operations
    (``_cheb_cols``: 2 * t * T_{k-1} - T_{k-2})."""
    cols = [torch.ones_like(t), t]
    for _ in range(2, nb):
        cols.append(2.0 * t * cols[-1] - cols[-2])
    return cols[:nb]


def cell_uv(px, py, spec: GridSpec, h: float):
    """(live, u, v) as ``[nc, C]``: each slot's cell-local coordinates, the
    cell's (cx, cy) formed in float32 from its flat index as JAX forms them.
    The divisors are device tensors: PyTorch on CUDA divides by a host scalar
    as a multiply by its reciprocal (see ``ops/grid.py::cell_index``), which
    can put a slot on its cell's edge past |u| = 1."""
    gh, gw, C = px.shape
    nc = gh * gw
    px, py = px.reshape(nc, C), py.reshape(nc, C)
    cell = torch.arange(nc, dtype=torch.float32, device=px.device)[:, None]
    gw_t, h_t = (torch.full((), float(d), dtype=torch.float32, device=px.device)
                 for d in (gw, h))
    cy = torch.floor(cell / gw_t)
    cx = cell - cy * gw
    live = px < 0.5 * SENT
    u = torch.where(live, 2.0 * (px - spec.x_min - cx * h) / h_t - 1.0, 0.0)
    v = torch.where(live, 2.0 * (py - spec.y_min - cy * h) / h_t - 1.0, 0.0)
    return live, u, v


def _check_planes(px, spec: GridSpec) -> None:
    if px.dim() != 3 or tuple(px.shape[:2]) != (spec.gh, spec.gw):
        raise ValueError(f"planes {tuple(px.shape)} do not match the grid {spec.gh} x {spec.gw}")


def moments_plain(px, py, weights, spec: GridSpec, h: float, deg: int = 12):
    """Plain PyTorch version of K14a: ``[gh, gw, n_w, 256]`` moments."""
    nb = check_deg(deg)
    _check_planes(px, spec)
    gh, gw, C = px.shape
    nc = gh * gw
    live, u, v = cell_uv(px, py, spec, h)
    tu = torch.stack(cheb_cols(u, nb), dim=1)  # [nc, nb, C]
    tv = torch.stack(cheb_cols(v, nb), dim=-1)  # [nc, C, nb]
    m = torch.zeros((nc, len(weights), BPAD, BPAD), dtype=torch.float32, device=px.device)
    for c, w in enumerate(weights):
        w = torch.where(live, w.reshape(nc, C), 0.0)
        m[:, c, :nb, :nb] = torch.bmm(w[:, None, :] * tu, tv)
    return m.reshape(gh, gw, len(weights), BPAD * BPAD)


def evaluate_plain(px, py, L, spec: GridSpec, h: float, n_pairs: int, deg: int = 12):
    """Plain PyTorch version of K14c: ``n_pairs`` planes ``[gh, gw, C]``."""
    nb = check_deg(deg)
    _check_planes(px, spec)
    gh, gw, C = px.shape
    nc = gh * gw
    live, u, v = cell_uv(px, py, spec, h)
    tu = cheb_cols(u, nb)
    tvt = torch.stack(cheb_cols(v, nb), dim=1)  # [nc, nb(b), C]
    lr = L.reshape(nc, n_pairs, BPAD, BPAD)
    outs = []
    for p in range(n_pairs):
        y = torch.bmm(lr[:, p, :nb, :nb], tvt)  # [nc, nb(a), C]
        acc = torch.zeros_like(u)
        for a in range(nb):
            acc = acc + tu[a] * y[:, a, :]
        outs.append(torch.where(live, acc, 0.0).reshape(gh, gw, C))
    return tuple(outs)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def moments(px, py, weights, spec: GridSpec, h: float, deg: int = 12):
    """Kernel K14a: per-cell Chebyshev moments of the ``n_w`` weight planes
    (1..4), ``[gh, gw, n_w, 256]`` in JAX's ``16a + b`` layout, 0 in the
    padding.  Launches K14a for CUDA tensors; runs the plain version for CPU
    tensors."""
    if not 1 <= len(weights) <= MAX_WEIGHTS:
        raise ValueError(f"K14a takes 1..{MAX_WEIGHTS} weight planes, got {len(weights)}")
    if _lib.dispatch(px) == "plain":
        return moments_plain(px, py, weights, spec, h, deg)
    nb = check_deg(deg)
    _check_planes(px, spec)
    _lib.require_cuda_planes(px, py, *weights)
    gh, gw, C = px.shape
    if C > 256:
        raise ValueError(f"K14a stages at most 256 slots a cell, got {C}")
    m = torch.empty((gh, gw, len(weights), BPAD * BPAD), dtype=torch.float32,
                    device=px.device)
    _lib.check("rps_fm_moments", _lib.library().rps_fm_moments(
        px.data_ptr(), py.data_ptr(), _ptrs(weights), m.data_ptr(), len(weights), gh * gw,
        gw, C, nb, spec.x_min, spec.y_min, h, _lib.stream()))
    moments.launches += 1
    return m


moments.launches = 0


def evaluate(px, py, L, spec: GridSpec, h: float, n_pairs: int, deg: int = 12):
    """Kernel K14c: each live slot's ``sum_a T_a(u) sum_b L[cell, p, a, b]
    T_b(v)`` for the ``n_pairs`` (1..8) transfer planes of ``L`` (``[gh, gw,
    n_pairs, 256]``), as ``n_pairs`` planes ``[gh, gw, C]``, 0 on dead slots.
    Launches K14c for CUDA tensors; runs the plain version for CPU tensors."""
    if not 1 <= n_pairs <= MAX_PAIRS:
        raise ValueError(f"K14c takes 1..{MAX_PAIRS} pairs, got {n_pairs}")
    if tuple(L.shape) != (*px.shape[:2], n_pairs, BPAD * BPAD):
        raise ValueError(f"L {tuple(L.shape)} is not [gh, gw, {n_pairs}, 256]")
    if _lib.dispatch(px) == "plain":
        return evaluate_plain(px, py, L, spec, h, n_pairs, deg)
    nb = check_deg(deg)
    _check_planes(px, spec)
    _lib.require_cuda_planes(px, py)
    if L.device != px.device or L.dtype != torch.float32 or not L.is_contiguous():
        raise ValueError("L must be a contiguous float32 tensor on the planes' device")
    gh, gw, C = px.shape
    if C > 1024:
        raise ValueError(f"K14c takes at most 1024 slots a cell, got {C}")
    outs = [torch.empty_like(px) for _ in range(n_pairs)]
    _lib.check("rps_fm_eval", _lib.library().rps_fm_eval(
        px.data_ptr(), py.data_ptr(), L.data_ptr(), _ptrs(outs), n_pairs, gh * gw, gw, C,
        nb, spec.x_min, spec.y_min, h, _lib.stream()))
    evaluate.launches += 1
    return tuple(outs)


evaluate.launches = 0
