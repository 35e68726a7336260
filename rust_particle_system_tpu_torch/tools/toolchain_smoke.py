"""Toolchain smoke test on the card: the numeric traps the port relies on.

Counterpart of ``tools/tpu_smoke.py:59-150`` (its three probe kernels) and
``protos/bf16_repro.py:20-25`` and ``:59-62``.  Each probe runs a kernel of
``ops/cuda/toolchain_probe.py`` (K13a-e) and returns a detail string:

* ``dot_precision_trap``: a float32 product on the tensor cores in TF32
  (K13b, and ``torch.matmul`` with ``allow_tf32`` set) is NOT float32, while
  the CUDA-core product (K13a) and ``torch.matmul`` under the port's
  settings are (the TPU's trap was its MXU's bf16 default);
* ``onehot_passthrough_precision``: a one-hot product passes values through
  bit for bit (K13a and ``torch.matmul``; K13b's result is reported);
* ``ids_f32_roundtrip``: integers to 2^24 and subnormals survive a kernel
  multiply (K13c; the build flushes no subnormal);
* ``bf16_broadcast_reshape``: a bf16 row broadcast, reshape and cast (K13d)
  gives its plain version's bits;
* ``bf16_outer_product``: bf16 casts, new axes and a bf16 outer product
  (K13e) give their plain version's bits.

Run on a card (it exits nonzero on any failure, and without a card):

    python -m rust_particle_system_tpu_torch.tools.toolchain_smoke

It writes no file.  The dot trap cannot be shown on the CPU, where torch
ignores ``allow_tf32``; the tests run the plain halves there.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops.cuda.toolchain_probe import (
    bf16_broadcast, bf16_broadcast_plain, bf16_outer, bf16_outer_plain, copy_ids, dot_f32,
    dot_tf32, require_fp32_matmul)

ID_PROBES = (0, 1, 2, 255, 8_388_607, 8_388_608, 16_777_215, 16_777_216)
SUBNORMALS = (float(np.finfo(np.float32).smallest_subnormal), 1e-40)


def dot_inputs():
    """Two seeded 128 x 128 standard-normal float32 matrices."""
    return tuple(np.random.default_rng(s).standard_normal((128, 128)).astype(np.float32)
                 for s in (1, 2))


def onehot_inputs():
    """(vals [8, 256] with the small probe pi * 1e-8 at [0, 0], one-hot
    [256, 128], perm): ``vals @ onehot == vals[:, perm]`` (tpu_smoke.py:111-116)."""
    vals = np.random.default_rng(3).standard_normal((8, 256)).astype(np.float32) * 1e3
    vals[0, 0] = np.float32(np.pi) * np.float32(1e-8)
    perm = np.random.default_rng(0).permutation(256)[:128]
    onehot = np.zeros((256, 128), np.float32)
    onehot[perm, np.arange(128)] = 1.0
    return vals, onehot, perm


def ids_inputs():
    """[8, 128] float32: the id probes, then the two subnormals, in row 0."""
    x = np.zeros((8, 128), np.float32)
    probes = np.float32(ID_PROBES + SUBNORMALS)
    x[0, : len(probes)] = probes
    return x


def bf16_inputs():
    """Seeded, non-constant [8, 128] bfloat16 values (JAX's repro feeds ones)."""
    x = np.random.default_rng(5).standard_normal((8, 128)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def bf16_outer_inputs():
    """Seeded, non-constant [8, 128] float32 (a, b) (JAX's repro feeds ones)."""
    rng = np.random.default_rng(6)
    return tuple(torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
                 for _ in range(2))


def _require(ok: bool, msg: str) -> None:
    """Fail a probe (an AssertionError that ``python -O`` keeps)."""
    if not ok:
        raise AssertionError(msg)


def dot_precision_trap(device: str = "cuda") -> str:
    """K13a within 1e-4 of the float64 product and K13b beyond it; the same
    for torch.matmul under the port's settings and with allow_tf32 set
    (restored after)."""
    a, b = dot_inputs()
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)

    def err(c):
        return float(np.abs(c.cpu().numpy().astype(np.float64) - want).max())

    e_f32, e_tf32 = err(dot_f32(ta, tb)), err(dot_tf32(ta, tb))
    require_fp32_matmul()
    e_mm = err(ta @ tb)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        e_mm_tf32 = err(ta @ tb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _require(e_f32 < 1e-4, f"K13a (FP32) deviates from float64 by {e_f32}")
    _require(e_mm < 1e-4, f"torch.matmul under the port's settings deviates by {e_mm}")
    _require(e_tf32 > 1e-4, f"K13b (TF32) matches float32 ({e_tf32}): the trap is gone?")
    _require(e_mm_tf32 > 1e-4,
             f"torch.matmul with allow_tf32 matches float32 ({e_mm_tf32}): the trap is gone?")
    return (f"TF32 err K13b {e_tf32:.2e}, torch.matmul with allow_tf32 {e_mm_tf32:.2e} "
            f"(trap confirmed); FP32 err K13a {e_f32:.2e}, torch.matmul {e_mm:.2e}")


def onehot_passthrough_precision(device: str = "cuda") -> str:
    """One-hot products pass values through bit for bit: K13a and
    torch.matmul in full float32 (asserted), K13b in TF32 (reported)."""
    vals, onehot, perm = onehot_inputs()
    want = vals[:, perm]
    tv, to = torch.from_numpy(vals).to(device), torch.from_numpy(onehot).to(device)

    def exact(c):
        return bool(np.array_equal(c.cpu().numpy(), want))

    f32, tf32 = exact(dot_f32(tv, to)), exact(dot_tf32(tv, to))
    require_fp32_matmul()
    mm = exact(tv @ to)
    _require(f32, "K13a one-hot pass-through NOT bit-exact")
    _require(mm, "torch.matmul (FP32) one-hot pass-through NOT bit-exact")
    return f"bit-exact: K13a={f32} torch.matmul={mm} K13b (TF32)={tf32}"


def ids_f32_roundtrip(device: str = "cuda") -> str:
    """K13c: every probe value survives ``x * 1.0`` bit for bit."""
    x = ids_inputs()
    got = copy_ids(torch.from_numpy(x).to(device)).cpu().numpy()
    _require(np.array_equal(got.view(np.uint32), x.view(np.uint32)),
             "ids or subnormals corrupted by a kernel multiply")
    return "integers 0..2^24 and subnormals 1.4e-45, 1e-40 survive a kernel multiply"


def bf16_broadcast_reshape(device: str = "cuda") -> str:
    """K13d bit-equal to its plain version on the CPU."""
    x = bf16_inputs()
    got = bf16_broadcast(x.to(device)).cpu()
    want = bf16_broadcast_plain(x)
    _require(tuple(got.shape) == (4, 256) and torch.equal(
        got.view(torch.int32), want.view(torch.int32)), "bf16 broadcast-reshape differs")
    return "bf16 [8, 128] row broadcast -> [4, 256] float32 bit-equal to the plain version"


def bf16_outer_product(device: str = "cuda") -> str:
    """K13e bit-equal to its plain version on the CPU."""
    a, b = bf16_outer_inputs()
    got = bf16_outer(a.to(device), b.to(device)).cpu()
    want = bf16_outer_plain(a, b)
    _require(tuple(got.shape) == (8, 40, 128) and torch.equal(
        got.view(torch.int32), want.view(torch.int32)), "bf16 outer product differs")
    return ("bf16 casts, new axes, [8, 40] x [8, 128] outer product -> [8, 40, 128] "
            "bit-equal to the plain version")


PROBES = (("dot_precision_trap", dot_precision_trap),
          ("onehot_passthrough_precision", onehot_passthrough_precision),
          ("ids_f32_roundtrip", ids_f32_roundtrip),
          ("bf16_broadcast_reshape", bf16_broadcast_reshape),
          ("bf16_outer_product", bf16_outer_product))


def main(argv=None) -> int:
    """Run every probe on the card; print ``[smoke] PASS|FAIL <name>:
    <detail>`` per probe.  Returns 0 if all pass, else 1 (and 1 without a
    card)."""
    del argv
    if not torch.cuda.is_available():
        print("[smoke] FAIL: no CUDA card (the probes run on the card only)", flush=True)
        return 1
    print(f"[smoke] device: {torch.cuda.get_device_name(0)}", flush=True)
    ok = True
    for name, fn in PROBES:
        t0 = time.perf_counter()
        try:
            detail = fn("cuda")
            print(f"[smoke] PASS {name}: {detail} ({time.perf_counter() - t0:.2f} s)",
                  flush=True)
        except Exception as e:  # noqa: BLE001 -- report every probe, then fail
            ok = False
            print(f"[smoke] FAIL {name}: {type(e).__name__}: {e}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
