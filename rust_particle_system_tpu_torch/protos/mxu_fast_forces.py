"""The fast mode: a lossy moment-transfer (FMM M2L) force for the poly-in-d^2
SPH family, on PyTorch and CUDA.

Counterpart of ``protos/mxu_fast_forces.py`` (its docstring derives the
method).  Pair functions polynomial in d^2 factor through a tensor-Chebyshev
basis of degree ``deg`` (NB = deg + 1 terms per axis), which turns the exact
pair walks into three stages per force pass:

  A. moments   M_c[cell, a, b] = sum_slots w_c T_a(u) T_b(v)      (K14a)
  B. transfers L = sum_offsets C_o @ M_shift(o)                  (torch.matmul)
  C. eval      E[slot] = Phi(slot)^T L[cell]                     (K14c)

Fast family (Muller-style poly6; h = cell size):
  u3 = (h^2-d^2)+^3 (density and viscosity weight), dxu2 = dx (h^2-d^2)+^2;
  rho_i = sum_j u3;  P~_i = k (rho_i - rho0) / rho_i^2;
  fpress_i = sum_j (P~_i + P~_j) (dx, dy) u2;
  fvisc_i = nu (sum_j v_j u3 - v_i sum_j u3).
Pass 1 transfers (u3, 1) -> rho; pass 2 the 7 (function, channel) pairs of
``PAIRS_2`` over the 4 moment channels (1, P~, vx, vy).

``oracle_forces`` walks every pair of the same family exactly (the check).
Stage B is 9 offsets x the pairs of ``[nc, 256] @ [256, 256]`` products, as
JAX leaves them to an XLA einsum at ``Precision.HIGHEST``: it runs in full
float32 and raises if the caller turned on TF32.

One difference from the JAX script: the degree is an argument of every
function (default 12), and only :func:`main` reads the command line (the JAX
script parses ``sys.argv`` when it is imported).  Run, on a card unless
``--device cpu`` is given (the plain versions; ``check`` only):

    python -m rust_particle_system_tpu_torch.protos.mxu_fast_forces \\
        [check|time|stages|both ...] [deg] [--device cuda|cpu] [--n N]

``check``: 30k particles on (-192, 192, -108, 108), h = 9, capacity 64, vstd
30: rel-max and rel-rms of each output against ``oracle_forces``, held to
``BARS``.  ``time`` / ``stages``: 1M uniform on (-960, 960, -540, 540), C =
64, vx = 1, vy = -1: end-to-end ms, or A, A+B, A+B+C by CUDA events and each
stage's device time by the profiler; beside them the exact production walks
(K2 + K3 through ``walk_and_integrate``) on the same planes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import make_params
from ..core.state import make_state
from ..models.base import model_device
from ..ops.cuda.fast_forces import BPAD, SENT, check_deg, evaluate, moments
from ..ops.cuda.rebin import walk_positions
from ..ops.cuda.resident import plane_state_from_particles, walk_and_integrate
from ..ops.cuda.toolchain_probe import require_fp32_matmul
from ..ops.grid import GridSpec
from ..runtime.profiling import device_ms
from ..runtime.timing import cuda_ms

__all__ = ["cheb_nodes", "dct_coeffs", "build_transfers", "moments", "transfers",
           "evaluate", "fast_forces", "oracle_forces", "main"]

TC = 8  # cells per program of the TPU kernels (the CUDA kernels take one per block)
K_PRESS = 800.0
RHO0 = 8.0
NU = 0.5
H = 9.0
OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
PAIRS_2 = [(1, 0), (1, 1), (2, 0), (2, 1), (0, 0), (0, 2), (0, 3)]
NAMES = ("rho", "fx", "fy", "fvx", "fvy")
# check's bars on rel-max against the oracle (JAX on the TPU at 30k: rho
# 1.4e-4, fx/fy 3.0e-3/3.3e-3, fvx/fvy ~1.1e-4; the degree-12 fit floor).
BARS = {"rho": 5e-4, "fx": 1e-2, "fy": 1e-2, "fvx": 5e-4, "fvy": 5e-4}
CHECK_BOUNDS = (-192.0, 192.0, -108.0, 108.0)
TIME_BOUNDS = (-960.0, 960.0, -540.0, 540.0)


# ---------------------------------------------------------------------------
# transfer-matrix setup (numpy Chebyshev interpolation, once)
# ---------------------------------------------------------------------------


def cheb_nodes(n):
    return np.cos(np.pi * (np.arange(n) + 0.5) / n)


def dct_coeffs(vals):
    from scipy.fft import dct

    c = vals
    for ax in range(vals.ndim):
        c = dct(c, type=2, axis=ax) / vals.shape[ax]
    for ax in range(vals.ndim):
        sl = [slice(None)] * vals.ndim
        sl[ax] = 0
        c[tuple(sl)] *= 0.5
    return c


def build_transfers(h: float, deg: int = 12) -> torch.Tensor:
    """C_pad[f, o, 256, 256] (a CPU tensor): 4D Chebyshev coefficient tensors,
    padded to the [16a + b] layout.  f in (u3, dxu2, dyu2); o enumerates the
    3x3 offsets.  Float64 numpy, as JAX builds it, so the float32 table is
    bit-equal to JAX's."""
    nb = check_deg(deg)
    g = cheb_nodes(nb)
    loc = 0.5 * (g + 1.0)  # cell-local in [0, 1] (units of h)
    out = np.zeros((3, 9, 256, 256), np.float32)
    for oi, (oy, ox) in enumerate(OFFSETS):
        XI, YI, XJ, YJ = np.meshgrid(loc, loc, ox + loc, oy + loc, indexing="ij")
        dx = (XJ - XI) * h
        dy = (YJ - YI) * h
        u = np.maximum(h * h - dx * dx - dy * dy, 0.0)
        vals = {0: u ** 3, 1: dx * u * u, 2: dy * u * u}
        for f, v in vals.items():
            c = dct_coeffs(v.copy())  # [a, b, ce...] = [NB, NB, NB, NB]
            cp = np.zeros((BPAD,) * 4, np.float32)
            cp[:nb, :nb, :nb, :nb] = c
            out[f, oi] = cp.reshape(256, 256)
    return torch.from_numpy(out)


# ---------------------------------------------------------------------------
# Stage B: transfers (torch.matmul over shifted moment planes)
# ---------------------------------------------------------------------------


def transfers(M, pairs, Cs):
    """M [gh, gw, n_w, 256]; pairs = list of (f, c) output channels.
    Returns L [gh, gw, n_pairs, 256], summed over the offsets in JAX's order,
    in full float32 (raises if TF32 is on)."""
    require_fp32_matmul()
    gh, gw = M.shape[:2]
    padded = F.pad(M, (0, 0, 0, 0, 1, 1, 1, 1))
    L = torch.zeros((gh, gw, len(pairs), 256), dtype=torch.float32, device=M.device)
    for oi, (oy, ox) in enumerate(OFFSETS):
        mo = padded[1 + oy: 1 + oy + gh, 1 + ox: 1 + ox + gw]
        for pi, (f, c) in enumerate(pairs):
            L[:, :, pi, :] += torch.matmul(mo[:, :, c, :], Cs[f, oi].T)
    return L


# ---------------------------------------------------------------------------
# The fast-mode force pass and its exact oracle
# ---------------------------------------------------------------------------


def fast_forces(px, py, vx, vy, spec: GridSpec, h: float, Cs, deg: int = 12):
    """(rho, fx, fy, fvx, fvy) planes: pass 1 (1 channel, 1 pair) gives the
    density, pass 2 (4 channels, 7 pairs) the forces.  Stages A and C run
    K14a and K14c for CUDA planes, their plain versions for CPU planes."""
    live = px < 0.5 * SENT
    one = torch.where(live, 1.0, 0.0)
    M1 = moments(px, py, [one], spec, h, deg)
    L1 = transfers(M1, [(0, 0)], Cs)
    (rho,) = evaluate(px, py, L1, spec, h, 1, deg)
    rho = torch.clamp_min(rho, 1e-6)
    pt = torch.where(live, K_PRESS * (rho - RHO0) / (rho * rho), 0.0)
    M2 = moments(px, py, [one, pt, vx, vy], spec, h, deg)
    L2 = transfers(M2, PAIRS_2, Cs)
    ex1, exp_, ey1, eyp, eu1, euvx, euvy = evaluate(px, py, L2, spec, h, 7, deg)
    fx = pt * ex1 + exp_
    fy = pt * ey1 + eyp
    fvx = NU * (euvx - vx * eu1)
    fvy = NU * (euvy - vy * eu1)
    return rho, fx, fy, fvx, fvy


def oracle_forces(px, py, vx, vy, h: float):
    """The same poly family by the dense plane walk (every pair of the 3x3
    cell windows), exact up to float32 sums.  Plain torch on any device."""
    gh, gw, _ = px.shape
    live = px < 0.5 * SENT
    pxp = F.pad(px, (0, 0, 1, 1, 1, 1), value=SENT)
    pyp = F.pad(py, (0, 0, 1, 1, 1, 1), value=SENT)
    vxp = F.pad(vx, (0, 0, 1, 1, 1, 1))
    vyp = F.pad(vy, (0, 0, 1, 1, 1, 1))

    def neigh(p):
        return [p[1 + dy: 1 + dy + gh, 1 + dx: 1 + dx + gw] for dy, dx in OFFSETS]

    def pair_terms(nx, ny):
        dx = nx[:, :, None, :] - px[:, :, :, None]
        dy = ny[:, :, None, :] - py[:, :, :, None]
        u = torch.clamp_min(h * h - dx * dx - dy * dy, 0.0)
        u = torch.where(dx.abs() > 2 * h, 0.0, u)  # sentinel guard
        return dx, dy, u

    def accum(weight_fn):
        acc = 0.0
        for nx, ny, nvx, nvy in zip(neigh(pxp), neigh(pyp), neigh(vxp), neigh(vyp)):
            dx, dy, u = pair_terms(nx, ny)
            acc = acc + weight_fn(dx, dy, u, nvx[:, :, None, :], nvy[:, :, None, :]).sum(-1)
        return acc

    rho = accum(lambda dx, dy, u, nvx, nvy: u * u * u)
    rho = torch.clamp_min(rho, 1e-6)
    pt = torch.where(live, K_PRESS * (rho - RHO0) / (rho * rho), 0.0)
    ptn = neigh(F.pad(pt, (0, 0, 1, 1, 1, 1)))

    def f_press(axis):
        acc = 0.0
        for i, (nx, ny) in enumerate(zip(neigh(pxp), neigh(pyp))):
            dx, dy, u = pair_terms(nx, ny)
            d = dx if axis == 0 else dy
            acc = acc + (d * u * u * (pt[:, :, :, None] + ptn[i][:, :, None, :])).sum(-1)
        return acc

    fx = f_press(0)
    fy = f_press(1)
    su = accum(lambda dx, dy, u, nvx, nvy: u * u * u)
    svx = accum(lambda dx, dy, u, nvx, nvy: nvx * (u * u * u))
    svy = accum(lambda dx, dy, u, nvx, nvy: nvy * (u * u * u))
    fvx = NU * (svx - vx * su)
    fvy = NU * (svy - vy * su)
    return rho, fx, fy, fvx, fvy


# ---------------------------------------------------------------------------
# The script's modes
# ---------------------------------------------------------------------------


def uniform_planes(n: int, bounds, capacity: int, device, seed: int = 0):
    """(spec, PlaneState) of n uniform particles (numpy, from ``seed``) on the
    h-cell grid of ``bounds``, binned by the port's plane init."""
    spec = GridSpec.from_bounds(bounds, H, capacity)
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(bounds[0], bounds[1], n),
                    rng.uniform(bounds[2], bounds[3], n)], -1).astype(np.float32)
    ps = plane_state_from_particles(make_state(torch.from_numpy(pos).to(device)), spec)
    if int(ps.lost):
        raise RuntimeError(f"{int(ps.lost)} of {n} particles did not fit capacity {capacity}")
    return spec, ps


def check_forces(device, deg: int = 12, n: int = 30_000, seed: int = 0) -> dict:
    """``check``: the fast mode against ``oracle_forces`` on n uniform
    particles with random velocities (vstd 30, vy downward).  Returns
    {output: (rel-max, rel-rms, scale)} over the live slots."""
    spec, ps = uniform_planes(n, CHECK_BOUNDS, 64, device, seed)
    live = ps.live
    rng = np.random.default_rng(seed + 1)
    normal = [torch.from_numpy(rng.standard_normal(tuple(ps.px.shape)).astype(np.float32))
              .to(device) for _ in range(2)]
    vstd = 30.0
    vx = torch.where(live, vstd * normal[0], 0.0)
    vy = torch.where(live, -vstd * normal[1].abs(), 0.0)
    Cs = build_transfers(H, deg).to(device)
    got = fast_forces(ps.px, ps.py, vx, vy, spec, H, Cs, deg)
    want = oracle_forces(ps.px, ps.py, vx, vy, H)
    errs = {}
    for name, g, w in zip(NAMES, got, want):
        g, w = g[live].double(), w[live].double()
        scale = max(float(w.abs().max()), 1e-12)
        err = (g - w).abs()
        errs[name] = (float(err.max()) / scale, float(err.square().mean().sqrt()) / scale,
                      scale)
    return errs


def time_inputs(device, deg: int = 12, n: int = 1_000_000, seed: int = 0):
    """``time``/``stages`` inputs: (spec, PlaneState, vx, vy, Cs) of n uniform
    particles at capacity 64 on the 1920 x 1080 bounds, vx = 1, vy = -1."""
    spec, ps = uniform_planes(n, TIME_BOUNDS, 64, device, seed)
    vx = torch.where(ps.live, 1.0, 0.0)
    vy = torch.where(ps.live, -1.0, 0.0)
    return spec, ps, vx, vy, build_transfers(H, deg).to(device)


def production_walks_ms(spec, ps, reps: int = 20) -> float:
    """The exact production walks on the same planes: K2, the pressure terms
    and K3 with its frame tail (``walk_and_integrate``), handed the walk
    planes as K1 writes them (``walk_positions``, outside the timing)."""
    params = make_params(bounds=TIME_BOUNDS, smoothing_radius=H)
    planes = (ps.px, ps.py, ps.vx, ps.vy)
    walk = walk_positions(ps.px, ps.py, spec)
    return cuda_ms(lambda: walk_and_integrate(planes, walk, spec, params, True), reps)


def time_forces(inputs, deg: int = 12, reps: int = 20) -> dict:
    """``time``: fast_forces end to end on ``time_inputs``, ms by CUDA
    events."""
    spec, ps, vx, vy, Cs = inputs
    return {"fast-mode forces": cuda_ms(
        lambda: fast_forces(ps.px, ps.py, vx, vy, spec, H, Cs, deg), reps)}


def time_stages(inputs, deg: int = 12, reps: int = 20) -> dict:
    """``stages``: pass 2 (4 moment channels, 7 pairs, 7 evaluations) on
    ``time_inputs`` as A, A+B, A+B+C by CUDA events and each stage alone by
    the profiler's device time."""
    spec, ps, vx, vy, Cs = inputs
    px, py = ps.px, ps.py
    one = torch.where(ps.live, 1.0, 0.0)
    w4 = [one, one, vx, vy]

    def a():
        return moments(px, py, w4, spec, H, deg)

    def ab():
        return transfers(a(), PAIRS_2, Cs)

    def abc():
        return evaluate(px, py, ab(), spec, H, 7, deg)

    M = a()
    L = transfers(M, PAIRS_2, Cs)
    return {"A moments (4ch)": cuda_ms(a, reps),
            "A+B (+7 transfers)": cuda_ms(ab, reps),
            "A+B+C (+7 evals)": cuda_ms(abc, reps),
            "A device (profiler)": device_ms(a, 5),
            "B device (profiler)": device_ms(lambda: transfers(M, PAIRS_2, Cs), 5),
            "C device (profiler)": device_ms(lambda: evaluate(px, py, L, spec, H, 7, deg), 5)}


MODES = ("check", "time", "stages", "both")


def parse_args(argv):
    """(modes, deg, device, n) from ``[mode ...] [deg] [--device D] [--n N]``;
    the modes default to ``both`` (check, then time)."""
    ap = argparse.ArgumentParser(
        prog="python -m rust_particle_system_tpu_torch.protos.mxu_fast_forces",
        description="The fast mode's accuracy against the exact walk (check) and its "
                    "times against the production walks (time, stages).")
    ap.add_argument("words", nargs="*", metavar="mode|deg",
                    help=f"modes ({', '.join(MODES)}; default both), then an optional degree "
                         "(default 12)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (check only)")
    ap.add_argument("--n", type=int, default=None,
                    help="particles (check: 30,000; time and stages: 1,000,000)")
    args = ap.parse_args(argv)
    words = list(args.words)
    deg = int(words.pop()) if words and words[-1].lstrip("-").isdigit() else 12
    bad = [w for w in words if w not in MODES]
    if bad:
        ap.error(f"unknown mode {bad[0]!r} (choose from {', '.join(MODES)})")
    return words or ["both"], deg, args.device, args.n


def main(argv=None) -> int:
    """Run the modes in order; the timing modes share one 1M input set and
    one timing of the production walks.  Returns 0, 1 if an output of
    ``check`` exceeded its bar, 2 if a timing mode was asked for on the CPU."""
    modes, deg, device_name, n_arg = parse_args(argv)
    check_deg(deg)
    device = model_device(device_name, "mxu_fast_forces")
    rc = 0
    if any(m in ("check", "both") for m in modes):
        n = n_arg or 30_000
        print(f"check: fast mode vs oracle_forces, {n} particles, deg {deg}, {device}",
              flush=True)
        for name, (rmax, rrms, scale) in check_forces(device, deg, n).items():
            ok = rmax <= BARS[name]
            rc |= not ok
            print(f"  {name:4s}: rel-max {rmax:9.2e}  rel-rms {rrms:9.2e}  (scale "
                  f"{scale:9.3e}; bar {BARS[name]:.0e} {'ok' if ok else 'EXCEEDED'})",
                  flush=True)
    timers = [time_stages if m == "stages" else time_forces for m in modes if m != "check"]
    if timers:
        if device.type != "cuda":
            print("time and stages measure the card: run them without --device cpu",
                  file=sys.stderr)
            return 2
        n = n_arg or 1_000_000
        inputs = time_inputs(device, deg, n)
        label = torch.cuda.get_device_name(device)
        results = {}
        for timer in timers:
            results.update(timer(inputs, deg))
        results["production walks (K2 + K3)"] = production_walks_ms(inputs[0], inputs[1])
        for name, ms in results.items():
            print(f"  {name:28s}: {ms:8.3f} ms  ({n} particles, deg {deg}, {label})",
                  flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
