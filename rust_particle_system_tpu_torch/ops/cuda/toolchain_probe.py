"""Toolchain probes: kernels K13a-e and their plain PyTorch versions.

Counterparts of the probe kernels of ``tools/tpu_smoke.py`` (the in-kernel
dot at :71 and :104, the id copy at :138) and of ``protos/bf16_repro.py``
(:31 and :65).  Each pins one numeric property of the toolchain and the card that the
port relies on (``csrc/toolchain_probe.cu`` says which); the probes that use
them are ``rust_particle_system_tpu_torch/tools/toolchain_smoke.py``.

    K13a dot_f32          float32 product on the CUDA cores
    K13b dot_tf32         the same on the tensor cores in TF32 (the trap)
    K13c copy_ids         x * 1.0, the 1.0 passed at run time
    K13d bf16_broadcast   bf16 row broadcast, reshape, cast to float32
    K13e bf16_outer       bf16 casts, then new axes, outer product in bf16

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from . import _lib


def require_fp32_matmul() -> None:
    """Raise unless ``torch.matmul`` multiplies float32 in full float32: TF32
    off and the matmul precision "highest" (torch's defaults).  Callers that
    pin full precision, as JAX pins ``Precision.HIGHEST``, check this instead
    of switching the settings themselves; the dot probe shows the trap."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is set: float32 "
                           "products would round their inputs to TF32")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("torch.get_float32_matmul_precision() is "
                           f"{torch.get_float32_matmul_precision()!r}, not 'highest'")


def _require_matrix(*ts: torch.Tensor, dtype=torch.float32) -> None:
    for t in ts:
        if t.dim() != 2 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous 2-D {dtype} tensors, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != ts[0].device or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on one device, got {t.device}")


def _check_product(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")


def dot_f32_plain(a, b):
    """Plain version of K13a: k in order, each step one multiply-add rounded
    once to float32 (formed in float64, where the product is exact)."""
    _check_product(a, b)
    a64, b64 = a.double(), b.double()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        acc = (acc.double() + a64[:, k, None] * b64[None, k, :]).float()
    return acc


def tf32_round(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (add half of
    the 13 dropped bits to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def dot_tf32_plain(a, b):
    """Plain version of K13b: the inputs rounded to TF32 (their products are
    exact in float32), each k-step of 8 summed exactly and added to the
    float32 accumulator, as one ``mma.m16n8k8`` step adds its products."""
    _check_product(a, b)
    at, bt = tf32_round(a).double(), tf32_round(b).double()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], 8):
        acc = (acc.double() + at[:, k0:k0 + 8] @ bt[k0:k0 + 8]).float()
    return acc


def copy_ids_plain(x):
    """Plain version of K13c: ``x * 1.0``."""
    return x * 1.0


def bf16_broadcast_plain(x):
    """Plain version of K13d: row 0 of ``[R, W]`` bfloat16 broadcast over the
    R rows, viewed as ``[R / 2, 2W]``, cast to float32 (bf16_repro.py:20-25)."""
    rows, width = x.shape
    if rows % 2:
        raise ValueError(f"expected an even number of rows, got {rows}")
    return x[0:1].expand(rows, width).reshape(rows // 2, 2 * width).to(torch.float32)


def dot_f32(a, b):
    """Kernel K13a: ``a @ b`` in float32 on the CUDA cores."""
    _check_product(a, b)
    if _lib.dispatch(a) == "plain":
        return dot_f32_plain(a, b)
    _require_matrix(a, b)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _lib.check("rps_probe_dot_f32", _lib.library().rps_probe_dot_f32(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, _lib.stream()))
    dot_f32.launches += 1
    return c


dot_f32.launches = 0


def dot_tf32(a, b):
    """Kernel K13b: ``a @ b`` on the tensor cores in TF32 (``mma.sync``
    m16n8k8).  The inner and column sizes must be multiples of 8; rows are
    padded with zeros to a multiple of 16 and cut off again."""
    _check_product(a, b)
    if _lib.dispatch(a) == "plain":
        return dot_tf32_plain(a, b)
    _require_matrix(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"K13b needs inner and column sizes divisible by 8, got {k}, {n}")
    mp = -(-m // 16) * 16
    if mp != m:
        a = torch.cat([a, a.new_zeros((mp - m, k))])
    c = torch.empty((mp, n), dtype=torch.float32, device=a.device)
    _lib.check("rps_probe_dot_tf32", _lib.library().rps_probe_dot_tf32(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), mp, n, k, _lib.stream()))
    dot_tf32.launches += 1
    return c[:m]


dot_tf32.launches = 0


def copy_ids(x):
    """Kernel K13c: ``x * 1.0`` with the 1.0 passed at run time, so the
    multiply is executed (and would flush subnormals under -ftz)."""
    if _lib.dispatch(x) == "plain":
        return copy_ids_plain(x)
    _lib.require_cuda_planes(x)
    o = torch.empty_like(x)
    _lib.check("rps_probe_copy", _lib.library().rps_probe_copy(
        x.data_ptr(), o.data_ptr(), x.numel(), 1.0, _lib.stream()))
    copy_ids.launches += 1
    return o


copy_ids.launches = 0


def bf16_broadcast(x):
    """Kernel K13d: the bf16 broadcast-reshape of ``bf16_broadcast_plain``."""
    if _lib.dispatch(x) == "plain":
        return bf16_broadcast_plain(x)
    _require_matrix(x, dtype=torch.bfloat16)
    rows, width = x.shape
    if rows % 2:
        raise ValueError(f"expected an even number of rows, got {rows}")
    o = torch.empty((rows // 2, 2 * width), dtype=torch.float32, device=x.device)
    _lib.check("rps_probe_bf16", _lib.library().rps_probe_bf16(
        x.data_ptr(), o.data_ptr(), rows, width, _lib.stream()))
    bf16_broadcast.launches += 1
    return o


bf16_broadcast.launches = 0


def _check_outer(a, b, width: int) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] or not 1 <= width <= a.shape[1]:
        raise ValueError(f"cannot form the outer product of {tuple(a.shape)}[:, :{width}] "
                         f"and {tuple(b.shape)}")


def bf16_outer_plain(a, b, width: int = 40):
    """Plain version of K13e: the first ``width`` columns of ``a`` [R, Wa]
    and ``b`` [R, B] cast to bfloat16, given new axes and multiplied in
    bfloat16 (``[R, width, B]``), cast to float32 (bf16_repro.py:59-62)."""
    _check_outer(a, b, width)
    bf = torch.bfloat16
    return (a[:, :width].to(bf)[:, :, None] * b.to(bf)[:, None, :]).to(torch.float32)


def bf16_outer(a, b, width: int = 40):
    """Kernel K13e: the bfloat16 outer product of ``bf16_outer_plain``."""
    _check_outer(a, b, width)
    if _lib.dispatch(a) == "plain":
        return bf16_outer_plain(a, b, width)
    _require_matrix(a, b)
    rows, wa = a.shape
    nb = b.shape[1]
    o = torch.empty((rows, width, nb), dtype=torch.float32, device=a.device)
    _lib.check("rps_probe_bf16_outer", _lib.library().rps_probe_bf16_outer(
        a.data_ptr(), b.data_ptr(), o.data_ptr(), rows, wa, width, nb, _lib.stream()))
    bf16_outer.launches += 1
    return o


bf16_outer.launches = 0
