"""The fast mode's stage A and C contraction forms at C = 128 slots a cell, on
a synthetic basis: kernels K14d-f and their plain PyTorch versions.

Counterparts of the three kernels of ``protos/fastmode_c128.py``.  Each cell
holds 128 weights ``w[s]``; the basis is built from them, not from positions,
``phi_a(s) = w[s] * a + a`` with ``a`` the basis index as float32, so the
probe measures the contraction and not the Chebyshev recurrence:

    K14d a_dot   out[cell, a, b] = sum_s (phi_a(s) w[s]) phi_b(s),  a, b < 13
                 (make_a_dot: a batched [13, 128] x [128, 13] dot per cell)
    K14e a_vpu   out[cell, r] = sum_s phi_r(s) w[s],                r < 176
                 (make_a_vpu: multiply and lane-reduce [176, 128] per cell)
    K14f c_vpu   out[cell, s] = sum_r phi_r(s) L[cell, r],          s < 128
                 (make_c_vpu: multiply and sublane-reduce [176, 128] per cell)

176 is the 2-D basis's 169 terms padded to the TPU's sublane tile, kept so
the functions are the TPU kernels'.  Each wrapper launches its kernel
(``csrc/fastmode_c128.cu``) for CUDA tensors and runs the plain version for
CPU tensors, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from . import _lib

B1 = 13  # deg-12 1-D basis
B2P = 176  # the 169 2-D terms padded to a multiple of 8
CP = 128  # slots a cell


def basis(w, n: int):
    """[cells, n, 128]: phi_a(s) = w[s] * a + a for a < n, rounded as the
    TPU kernels round it (a multiply, then an add)."""
    it = torch.arange(n, dtype=torch.float32, device=w.device)[None, :, None]
    return w[:, None, :] * it + it


def _check_w(w) -> None:
    if w.dim() != 2 or w.shape[1] != CP or w.dtype != torch.float32:
        raise ValueError(f"expected float32 weights [cells, {CP}], got {w.dtype} "
                         f"{tuple(w.shape)}")


def _check_l(w, l) -> None:
    if tuple(l.shape) != (w.shape[0], B2P) or l.dtype != torch.float32:
        raise ValueError(f"expected float32 moments [{w.shape[0]}, {B2P}], got {l.dtype} "
                         f"{tuple(l.shape)}")


def a_dot_plain(w):
    """Plain version of K14d: ``[cells, 13, 13]``."""
    _check_w(w)
    p = basis(w, B1)
    return torch.bmm(p * w[:, None, :], p.transpose(1, 2))


def a_vpu_plain(w):
    """Plain version of K14e: ``[cells, 176]``."""
    _check_w(w)
    return (basis(w, B2P) * w[:, None, :]).sum(-1)


def c_vpu_plain(w, l):
    """Plain version of K14f: ``[cells, 128]`` from the per-cell moments
    ``l`` ``[cells, 176]``."""
    _check_w(w)
    _check_l(w, l)
    return (basis(w, B2P) * l[:, :, None]).sum(1)


def a_dot(w):
    """Kernel K14d: ``a_dot_plain`` on the card, one block per cell."""
    _check_w(w)
    if _lib.dispatch(w) == "plain":
        return a_dot_plain(w)
    _lib.require_cuda_planes(w)
    out = torch.empty((w.shape[0], B1, B1), dtype=torch.float32, device=w.device)
    _lib.check("rps_c128_a_dot", _lib.library().rps_c128_a_dot(
        w.data_ptr(), out.data_ptr(), w.shape[0], _lib.stream()))
    a_dot.launches += 1
    return out


a_dot.launches = 0


def a_vpu(w):
    """Kernel K14e: ``a_vpu_plain`` on the card, one block per cell."""
    _check_w(w)
    if _lib.dispatch(w) == "plain":
        return a_vpu_plain(w)
    _lib.require_cuda_planes(w)
    out = torch.empty((w.shape[0], B2P), dtype=torch.float32, device=w.device)
    _lib.check("rps_c128_a_vpu", _lib.library().rps_c128_a_vpu(
        w.data_ptr(), out.data_ptr(), w.shape[0], _lib.stream()))
    a_vpu.launches += 1
    return out


a_vpu.launches = 0


def c_vpu(w, l):
    """Kernel K14f: ``c_vpu_plain`` on the card, one block per cell."""
    _check_w(w)
    _check_l(w, l)
    if _lib.dispatch(w) == "plain":
        return c_vpu_plain(w, l)
    _lib.require_cuda_planes(w)
    _lib.require_cuda_planes(l)
    if l.device != w.device:
        raise ValueError(f"expected the moments on {w.device}, got {l.device}")
    out = torch.empty_like(w)
    _lib.check("rps_c128_c_vpu", _lib.library().rps_c128_c_vpu(
        w.data_ptr(), l.data_ptr(), out.data_ptr(), w.shape[0], _lib.stream()))
    c_vpu.launches += 1
    return out


c_vpu.launches = 0
