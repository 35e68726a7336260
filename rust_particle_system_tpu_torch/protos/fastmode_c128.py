"""The fast mode's stage A and C contraction forms at C = 128 slots a cell.

Counterpart of ``protos/fastmode_c128.py``: with one cell per 128-slot row,
the cell-segmented contractions of the fast mode's stages A (per-cell
moments) and C (per-slot evaluations) have two native forms, a batched
mini-dot and a multiply-and-reduce.  This times its three kernels (K14d-f,
``ops/cuda/fastmode_c128.py``) at the 1M-particle geometry of the JAX probe:
8,750 cells (125 x 70, ~114 particles each) padded to 8,768, the deg-12
basis (13 per axis, 169 2-D terms padded to 176), and a synthetic basis
built from seeded per-(cell, slot) weights:

  A-dot  out[cell] = (Phi * w) Phi^T, [13, 128] x [128, 13] per cell (K14d)
  A-vpu  [176, 128] multiply and reduce over the slots (K14e)
  C-vpu  [176, 128] multiply and reduce over the basis (K14f)

Run, on a card unless ``--device cpu`` is given (the plain versions, timed
by the host clock):

    python -m rust_particle_system_tpu_torch.protos.fastmode_c128 [R]
        [--device cuda|cpu] [--cells N]

``R`` (default 32) is the calls timed per form, after one warm call; the
CUDA times are CUDA events over the R calls.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.base import model_device
from ..ops.cuda.fastmode_c128 import B2P, CP, a_dot, a_vpu, c_vpu
from ..runtime.timing import cuda_ms, time_fn

NC = 8750  # cells at the 1M / ~114-a-cell geometry (125 x 70)
NCP = 8768  # padded to a multiple of 8 cells (the TPU kernels' programs)


def inputs(n_cells: int, device, seed: int = 0):
    """Seeded (w [n_cells, 128], L [n_cells, 176]) float32, standard normal."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_cells, CP)).astype(np.float32)
    l = rng.standard_normal((n_cells, B2P)).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(l).to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rust_particle_system_tpu_torch.protos.fastmode_c128",
        description="Times the fast mode's stage A and C contraction forms at C=128.")
    ap.add_argument("reps", nargs="?", type=int, default=32, help="calls timed per form")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--cells", type=int, default=NCP, help=f"cells (default {NCP})")
    args = ap.parse_args(argv)
    if args.reps < 1 or args.cells < 1:
        ap.error("reps and cells must be positive")
    device = model_device(args.device, "fastmode_c128")
    w, l = inputs(args.cells, device)
    on_card = device.type == "cuda"
    clock = torch.cuda.get_device_name(device) if on_card else "host clock, plain versions"
    print(f"nc={NC} (padded {NCP}); {args.cells} cells x {CP} slots, R={args.reps} [{clock}]",
          flush=True)
    forms = {"A-dot  batched [13,128]x[128,13]": lambda: a_dot(w),
             "A-vpu  [176,128] mul+lane-reduce": lambda: a_vpu(w),
             "C-vpu  [176,128] mul+subl-reduce": lambda: c_vpu(w, l)}
    for label, fn in forms.items():
        ms = cuda_ms(fn, args.reps) if on_card else 1e3 * time_fn(
            lambda _: fn(), [(None,)], reps=args.reps, warm=1)
        print(f"  {label:34s}: {ms:7.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
