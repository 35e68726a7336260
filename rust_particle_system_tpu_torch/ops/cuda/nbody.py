"""All-pairs N-body accelerations: kernel K8 and its plain PyTorch version.

Counterpart of ``rust_particle_system_tpu/ops/pallas/nbody.py`` (the TPU kernel
``_kernel``, driven by ``nbody_accel_pallas``) and of the dense reference
``rust_particle_system_tpu/models/nbody.py:62-84`` (``pairwise_accel``,
``nbody_accel``), which the plain version here ports:

    a_i = sum_j delta_ij * (G s^3 - R eps s^4),  s = (|delta_ij|^2 + eps^2)^-1/2

:func:`nbody_accel` launches K8 (``csrc/nbody.cu``) for CUDA tensors and runs
the plain version for CPU tensors.  The plain version evaluates ``[ti, n]``
blocks of the pair matrix, chunked over i, so that a 16k-particle call stays
within a few hundred MB.
"""

from __future__ import annotations

import torch

from ...core.params import f32_mul
from . import _lib

PLAIN_CHUNK_PAIRS = 1 << 22  # pairs per plain block (16 MB per f32 temporary)


def pairwise_accel(pos_i, pos_j, params, self_mask):
    """Acceleration ``[ti, 2]`` of each row particle from all column particles
    (``[ti, 2]``, ``[tj, 2]``); ``self_mask`` (``[ti, tj]``) marks the i == j
    pairs to exclude.  The JAX reference's order of operations."""
    delta = pos_j[None, :, :] - pos_i[:, None, :]  # [ti, tj, 2]
    d2 = (delta * delta).sum(-1) + f32_mul(params.softening, params.softening)
    inv_d = torch.rsqrt(d2)
    attract = params.g_const * inv_d * inv_d * inv_d
    repel = params.repulsion * inv_d * inv_d * inv_d * inv_d * params.softening
    w = torch.where(self_mask, 0.0, attract - repel)
    return (delta * w[..., None]).sum(1)


def nbody_accel_plain(pos, params):
    """Plain PyTorch version of K8: the dense reference, chunked over i."""
    n = pos.shape[0]
    out = torch.empty_like(pos)
    step = max(1, PLAIN_CHUNK_PAIRS // max(n, 1))
    j = torch.arange(n, device=pos.device)
    for i0 in range(0, n, step):
        i = j[i0: i0 + step]
        out[i0: i0 + step] = pairwise_accel(pos[i0: i0 + step], pos, params,
                                            i[:, None] == j[None, :])
    return out


_nbody = _lib.kernel("rps_nbody_accel")


def nbody_accel(pos, params):
    """``[n, 2]`` positions -> ``[n, 2]`` accelerations.  Launches K8 for CUDA
    tensors; runs the plain version for CPU tensors."""
    if _lib.dispatch(pos) == "plain":
        return nbody_accel_plain(pos, params)
    _lib.require_cuda_planes(pos)
    n = pos.shape[0]
    if pos.dim() != 2 or pos.shape[1] != 2 or n < 1 or pos.data_ptr() % 8:
        raise ValueError("expected 8-byte aligned [n, 2] positions, n >= 1")
    acc = torch.empty_like(pos)
    _nbody(pos.data_ptr(), acc.data_ptr(), n, params.g_const,
           f32_mul(params.repulsion, params.softening),
           f32_mul(params.softening, params.softening))
    nbody_accel.launches += 1
    return acc


nbody_accel.launches = 0
