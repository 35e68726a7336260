#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout.  It needs one CUDA card, the CUDA toolkit
(nvcc) and PyTorch; it imports nothing of JAX.  Phases, one line each:

  0  the device (name, and nvidia-smi's name and power limit);
  1  build every kernel from csrc/ (seconds);
  2  each kernel against its plain PyTorch version on the card, at the
     main-path shape (default 1920x1080 bounds, 9-unit cells: gw=214, gh=121,
     C=128) from a 1M-particle uniform state after a few live frames:
     K5 and K1 bit-equal (K1 also on a state with air rows, and at C=16 and
     C=64 on a small grid); K2, K3 and K3b at the stated tolerances; the
     unfused tail (K3b) against the fused one (K3); K4 at rtol/atol 1e-4 on
     the 1080p image of the stepped state (sum rule, given colours, radius 2)
     and at a geometry the JAX package sends to its v1 rasterizer (K10); then
     the whole step against the plain path (CPU) on a small input;
  3  the user entry points, each path with the launch counts set to 0 just
     before it and read just after:
     scene  Simulation(SPHFluid.create(n=50_000)), gravity=400, 300 frames;
            lost == 0, live count exact after every chunk, warm-up frozen,
            finite, in bounds, the y centre of mass falls; sim.render() is a
            finite 1080p image; 10 model.step_and_render frames leave the
            state bit-equal to plane_step's;
     cli    runtime.cli.main(... --render build/chip_smoke_50k.png --stats),
            the PNG equal to the scene's image;
     unfused  plane_frame(fuse_tail=False) frames (K3b);
     v1     a model whose render geometry JAX sends to its v1 rasterizer
            (K10), step_and_render frames;
  4  1M particles, uniform, C=128: the step, the render alone and
     step_and_render, 40 frames each, timed with CUDA events.

Any failure raises and the exit code is nonzero.  The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BOUNDS = (-960.0, 960.0, -540.0, 540.0)
N_1M = 1_000_000


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (after one warm call),
    between CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def read_png(path):
    """[H, W, 4] uint8 of an RGBA8 PNG as the port's writer makes it (one IDAT
    stream, filter 0 on every row)."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8: pos + 8 + length]
        pos += 12 + length
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    require((depth, ctype) == (8, 6), "not an RGBA8 PNG")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 4 * w)
    require(bool(np.all(rows[:, 0] == 0)), "unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 4)


def close(a, b, rtol: float, atol: float, mask=None) -> bool:
    import torch

    if mask is not None:
        a, b = a[mask], b[mask]
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def demo_planes(torch, spec, fill_frac: float, drift: float, seed: int, device):
    """Random planes: each cell holds ~fill_frac*C particles at in-cell
    positions jittered by up to ``drift`` cells (channels px, py, vx, vy, idsf)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gh, gw, C = spec.gh, spec.gw, spec.capacity
    live = rng.random((gh, gw, C)) < fill_frac
    cx = np.arange(gw)[None, :, None] + rng.random((gh, gw, C))
    cy = np.arange(gh)[:, None, None] + rng.random((gh, gw, C))
    x = spec.x_min + (cx + (rng.random((gh, gw, C)) * 2 - 1) * drift) * spec.cell_width
    y = spec.y_min + (cy + (rng.random((gh, gw, C)) * 2 - 1) * drift) * spec.cell_size
    ids = np.arange(gh * gw * C, dtype=np.float32).reshape(gh, gw, C)
    chans = [np.where(live, x, 1e6), np.where(live, y, 1e6),
             np.where(live, rng.standard_normal((gh, gw, C)), 0.0),
             np.where(live, rng.standard_normal((gh, gw, C)), 0.0),
             np.where(live, ids, 0.0)]
    return [torch.as_tensor(c.astype(np.float32), device=device) for c in chans]


def uniform_plane_state(torch, spec, n: int, seed: int):
    from rust_particle_system_tpu_torch.core.state import make_state
    from rust_particle_system_tpu_torch.ops.cuda.resident import plane_state_from_particles

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((n, 2), generator=gen, device="cuda")
    lo = torch.tensor([BOUNDS[0], BOUNDS[2]], device="cuda")
    hi = torch.tensor([BOUNDS[1], BOUNDS[3]], device="cuda")
    return plane_state_from_particles(make_state(lo + u * (hi - lo)), spec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results here (JSON)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not (HERE / "rust_particle_system_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(rust_particle_system_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(HERE))
    import rust_particle_system_tpu_torch as port
    from rust_particle_system_tpu_torch.core.params import make_params
    from rust_particle_system_tpu_torch.models.sph import SPHFluid
    from rust_particle_system_tpu_torch.ops.cuda import _lib
    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.ops.cuda.plane_build import (
        cell_planes_aos, cell_planes_aos_plain)
    from rust_particle_system_tpu_torch.ops.cuda.rebin import (
        rebin_planes, rebin_planes_plain)
    from rust_particle_system_tpu_torch.ops.cuda.sph import (
        density_planes, density_planes_plain, force_planes, force_planes_integrated,
        force_planes_integrated_plain, force_planes_plain, force_scalars,
        pressure_terms)
    from rust_particle_system_tpu_torch.ops.grid import GridSpec, build_grid
    from rust_particle_system_tpu_torch.render import RenderSpec, to_srgb_u8
    from rust_particle_system_tpu_torch.render.splat_planes import (
        drifted_patch_margin, raster_inputs, raster_planes, raster_planes_plain)
    from rust_particle_system_tpu_torch.runtime import cli
    from rust_particle_system_tpu_torch.runtime.simulation import Simulation

    require(Path(port.__file__).resolve().parent.parent == HERE,
            f"imported the port from {port.__file__}, not from this checkout")
    require("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------- phase 0: device ----------------
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    print(f"phase 0: device {name} (count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    card = f"{smi}"

    # ---------------- phase 1: build ----------------
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    print(f"phase 1: kernels built from {len(_lib.sources())} sources in "
          f"{build_s:.2f} s -> {_lib.library_path()}")

    # ---------------- phase 2: kernels vs plain, main-path shape ----------------
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 128)
    require((spec.gw, spec.gh) == (214, 121), f"unexpected grid {spec}")
    params = make_params(bounds=BOUNDS, gravity=400.0)
    rows = {}

    def record(key, name, source, replaces, err, ms, plain_ms):
        rows[key] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms}

    # K5 on the 1M uniform binning.
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.rand((N_1M, 2), generator=gen, device="cuda")
    lo = torch.tensor([BOUNDS[0], BOUNDS[2]], device="cuda")
    hi = torch.tensor([BOUNDS[1], BOUNDS[3]], device="cuda")
    pos = lo + u * (hi - lo)
    grid = build_grid(spec, pos)
    ids = torch.arange(N_1M, device="cuda", dtype=torch.float32)
    packed = torch.cat([pos, torch.zeros_like(pos), ids[:, None]], -1)[grid.perm.long()]
    packed = packed.contiguous()
    fills = (1e6, 1e6, 0.0, 0.0, 0.0)
    args5 = (packed, grid.starts, spec.num_cells, spec.capacity, fills)
    a, b = cell_planes_aos(*args5), cell_planes_aos_plain(*args5)
    torch.cuda.synchronize()
    require(torch.equal(a, b), "K5 plane build differs from its plain version")
    record("K5", "K5 plane build", "rust_particle_system_tpu_torch/csrc/plane_build.cu",
           "rust_particle_system_tpu/ops/pallas/plane_build.py:44", max_abs(a, b),
           cuda_ms(lambda: cell_planes_aos(*args5), 20),
           cuda_ms(lambda: cell_planes_aos_plain(*args5), 5))
    print(f"phase 2: K5 bit-equal at {spec.num_cells} cells x {spec.capacity} slots")

    # A 1M state after a few live frames (kernels), then each kernel's inputs.
    ps = R.plane_state_from_particles(
        port.make_state(pos), spec)
    ps = dataclasses.replace(ps, frame=params.shader_delay)
    for _ in range(3):
        ps = R.plane_step(ps, params, spec)
    rin = R.predict_planes(ps, params)
    a, ca = rebin_planes(rin, spec)
    b, cb = rebin_planes_plain(rin, spec)
    require(all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(ca, cb),
            "K1 rebin differs from its plain version (1M stepped state)")
    k1_err = max(max_abs(x, y) for x, y in zip(a, b))
    # Air rows: rows 50..59 emptied, so rows 49 and 60 feed rows turning live.
    air = [p.clone() for p in rin]
    for c, p in enumerate(air):
        p[50:60] = 1e6 if c < 2 else 0.0
    a2, ca2 = rebin_planes(air, spec)
    b2, cb2 = rebin_planes_plain(air, spec)
    require(all(torch.equal(x, y) for x, y in zip(a2, b2)) and torch.equal(ca2, cb2),
            "K1 rebin differs from its plain version (air rows)")
    require(int((a2[0][50:60] < 5e5).sum()) > 0, "no particle entered the air band")
    for C in (16, 64):
        small = GridSpec(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7,
                         capacity=C)
        for drift in (0.4, 0.9, 1.8):
            pl = demo_planes(torch, small, 0.7, drift, seed=C + int(10 * drift),
                             device="cuda")
            x, cx = rebin_planes(pl, small)
            y, cy = rebin_planes_plain(pl, small)
            require(all(torch.equal(p, q) for p, q in zip(x, y)) and torch.equal(cx, cy),
                    f"K1 rebin differs from its plain version (C={C}, drift={drift})")
    record("K1", "K1 rebin", "rust_particle_system_tpu_torch/csrc/rebin.cu",
           "rust_particle_system_tpu/ops/pallas/rebin.py:442", k1_err,
           cuda_ms(lambda: rebin_planes(rin, spec), 20),
           cuda_ms(lambda: rebin_planes_plain(rin, spec), 5))
    print("phase 2: K1 bit-equal (1M stepped, air rows, C=16 and C=64 x drift 0.4/0.9/1.8)")

    npx, npy, nvx0, nvy0, _ = a
    fpx, fpy = R.walk_positions(npx, npy, spec)
    walk_live = fpx < 5e5
    rho, rhon = density_planes(fpx, fpy, params)
    h, dn, nn = (params.smoothing_radius, params.density_kernel_norm,
                 params.near_density_kernel_norm)
    prho, prhon = density_planes_plain(fpx, fpy, h, dn, nn)
    require(close(rho, prho, 1e-5, 0.0, walk_live) and close(rhon, prhon, 1e-5, 0.0, walk_live),
            "K2 density differs from its plain version beyond rtol 1e-5")
    require(bool(torch.all(rho[~walk_live] == 0)), "K2 wrote nonzero parked slots")
    record("K2", "K2 density walk", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137",
           max(max_abs(rho, prho, walk_live), max_abs(rhon, prhon, walk_live)),
           cuda_ms(lambda: density_planes(fpx, fpy, params), 20),
           cuda_ms(lambda: density_planes_plain(fpx, fpy, h, dn, nn), 2))
    print(f"phase 2: K2 within rtol 1e-5 on {int(walk_live.sum())} walk slots")

    def k3_inputs(qx, qy):
        """K3's inputs for true positions (qx, qy) resident in their slots."""
        wx, wy = R.walk_positions(qx, qy, spec)
        P1, NPo, NPn = pressure_terms(*density_planes(wx, wy, params), params)
        return (wx, wy, P1, NPn, nvx0, nvy0, NPo, qx, qy)

    def check_k3(fargs) -> tuple[float, int]:
        ko = force_planes_integrated(*fargs, params)
        po = force_planes_integrated_plain(*fargs, force_scalars(params))
        live = fargs[7] < 5e5
        require(close(ko[0], po[0], 1e-4, 1e-4, live)
                and close(ko[1], po[1], 1e-4, 1e-4, live),
                "K3 positions differ from the plain version beyond rtol/atol 1e-4")
        require(close(ko[2], po[2], 1e-4, 1e-2, live)
                and close(ko[3], po[3], 1e-4, 1e-2, live),
                "K3 velocities differ from the plain version beyond rtol 1e-4 / atol 1e-2")
        require(all(torch.equal(x[~live], y[~live]) for x, y in zip(ko, po)),
                "K3 dead slots not parked identically")
        deferred = live & ~(fargs[0] < 5e5)
        require(all(torch.equal(x[deferred], y[deferred]) for x, y in zip(ko, po)),
                "K3 deferred slots differ from the plain version")
        return max(max_abs(x, y, live) for x, y in zip(ko, po)), int(deferred.sum())

    fargs = k3_inputs(npx, npy)
    k3_err, _ = check_k3(fargs)
    # Forced deferrals: 5% of live slots keyed two cells to the right of their
    # resident cell (the epilogue must restore and integrate them).
    gsel = torch.Generator(device="cuda").manual_seed(5)
    pick = (npx < 5e5) & (torch.rand(npx.shape, generator=gsel, device="cuda") < 0.05)
    far_x = torch.where(pick, (npx + 2 * spec.cell_width).clamp(max=BOUNDS[1]), npx)
    k3_err_d, n_def = check_k3(k3_inputs(far_x, npy))
    require(n_def > 10_000, f"too few deferred slots ({n_def})")
    record("K3", "K3 force walk + tail", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", max(k3_err, k3_err_d),
           cuda_ms(lambda: force_planes_integrated(*fargs, params), 20),
           cuda_ms(lambda: force_planes_integrated_plain(*fargs, force_scalars(params)), 2))
    print("phase 2: K3 within pos 1e-4, vel rtol 1e-4 / atol 1e-2; deferred slots "
          f"bit-equal ({n_def} forced)")

    # K3b: the raw walk on K3's inputs; held through the velocity update it
    # feeds (K3's velocity bars), parked walk slots bit-equal.
    bargs = fargs[:7]
    kraw = force_planes(*bargs, params)
    praw = force_planes_plain(*bargs, force_scalars(params))
    scal = force_scalars(params)
    wl = fargs[0] < 5e5
    k3b_err = 0.0
    for v, fi, fvi in ((nvx0, 0, 2), (nvy0, 1, 3)):
        kv = v + kraw[fi] * scal[2] + kraw[fvi] * scal[3]
        pv = v + praw[fi] * scal[2] + praw[fvi] * scal[3]
        require(close(kv, pv, 1e-4, 1e-2, wl),
                "K3b velocity update differs from the plain version beyond rtol 1e-4 / atol 1e-2")
        k3b_err = max(k3b_err, max_abs(kv, pv, wl))
    require(all(torch.equal(x[~wl], y[~wl]) for x, y in zip(kraw, praw)),
            "K3b parked walk slots differ from the plain version")
    record("K3b", "K3b force walk, raw sums", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", k3b_err,
           cuda_ms(lambda: force_planes(*bargs, params), 20),
           cuda_ms(lambda: force_planes_plain(*bargs, force_scalars(params)), 2))
    # The unfused tail (K3b + torch) against the fused one (K3): one frame on
    # the 1M state, slot by slot (the rebin before the walks is shared).
    fu = R.plane_step(ps, params, spec, fuse_tail=False)
    fz = R.plane_step(ps, params, spec, fuse_tail=True)
    lv = fz.live
    require(torch.equal(fu.live, lv) and torch.equal(fu.idsf, fz.idsf),
            "fused and unfused tails placed particles differently")
    require(max_abs(fu.px, fz.px, lv) <= 1e-4 and max_abs(fu.py, fz.py, lv) <= 1e-4
            and max_abs(fu.vx, fz.vx, lv) <= 1e-3 and max_abs(fu.vy, fz.vy, lv) <= 1e-3,
            "unfused tail differs from the fused one beyond pos 1e-4 / vel 1e-3")
    tail_err = (max(max_abs(fu.px, fz.px, lv), max_abs(fu.py, fz.py, lv)),
                max(max_abs(fu.vx, fz.vx, lv), max_abs(fu.vy, fz.vy, lv)))
    print(f"phase 2: K3b velocity update within rtol 1e-4 / atol 1e-2 ({k3b_err:.2e}); "
          f"unfused vs fused tail, 1M: pos {tail_err[0]:.2e} vel {tail_err[1]:.2e}")

    # K4 on the image of the stepped 1M state: the fused frame's inputs (sum
    # rule), given colours (4 channels), radius-2 sprites (margin 3).
    def check_k4(label, st, sp, rs, **kw):
        ins = raster_inputs(st.px, st.py, st.vx, st.vy, st.live, params.particle_size,
                            params.max_energy, bounds_static=sp[0], grid_spec=sp[1],
                            render_spec=rs,
                            margin=drifted_patch_margin(sp[1], rs, sp[0]), **kw)
        ka = raster_planes(*ins, True)
        pa = raster_planes_plain(*ins, True)
        require(close(ka, pa, 1e-4, 1e-4),
                f"K4 ({label}) differs from its plain version beyond rtol/atol 1e-4")
        require(float(pa[-1].sum()) > 0, f"K4 ({label}): nothing drawn")
        return ins, max_abs(ka, pa)

    rs_main = RenderSpec()
    img_st = R.plane_step(ps, params, spec)
    k4_ins, k4_err = check_k4("main path, sum rule", img_st, (BOUNDS, spec), rs_main,
                              color_sum=1.0)
    gcol = torch.Generator(device="cuda").manual_seed(11)
    given = tuple(torch.rand(img_st.px.shape, generator=gcol, device="cuda")
                  for _ in range(3))
    _, e4 = check_k4("given colours", img_st, (BOUNDS, spec), rs_main, colors=given)
    rs2 = RenderSpec(max_radius_px=2)
    require(drifted_patch_margin(spec, rs2, BOUNDS) == 3, "radius-2 margin")
    _, e2 = check_k4("radius 2", img_st, (BOUNDS, spec), rs2, color_sum=1.0)
    record("K4", "K4 plane rasterizer", "rust_particle_system_tpu_torch/csrc/splat_planes.cu",
           "rust_particle_system_tpu/render/splat_planes.py:222", max(k4_err, e4, e2),
           cuda_ms(lambda: raster_planes(*k4_ins, True), 20),
           cuda_ms(lambda: raster_planes_plain(*k4_ins, True), 2))
    # K10: bounds (0, 90, 0, 45), 9-unit cells, a 90x180 image: sy = 36 px,
    # patch height 42 > 32, so the JAX package takes its v1 rasterizer.
    v1_bounds = (0.0, 90.0, 0.0, 45.0)
    v1_spec = GridSpec.from_bounds(v1_bounds, 9.0, 128)
    v1_rs = RenderSpec(width=90, height=180, max_radius_px=2)
    pl = demo_planes(torch, v1_spec, 0.4, 0.3, seed=12, device="cuda")
    v1_st = R.PlaneState(px=pl[0], py=pl[1], vx=pl[2] * 40, vy=pl[3] * 40, idsf=pl[4],
                         frame=0, lost=ps.lost, n=int((pl[0] < 5e5).sum()))
    k10_ins, k10_err = check_k4("v1 geometry", v1_st, (v1_bounds, v1_spec), v1_rs,
                                color_sum=1.0)
    _, e10 = check_k4("v1 geometry, given colours", v1_st, (v1_bounds, v1_spec), v1_rs,
                      colors=(pl[2].abs(), pl[3].abs(), pl[2].abs()))
    record("K10", "K10 plane rasterizer, v1 geometry (the K4 kernel)",
           "rust_particle_system_tpu_torch/csrc/splat_planes.cu",
           "rust_particle_system_tpu/render/splat_planes.py:156", max(k10_err, e10),
           cuda_ms(lambda: raster_planes(*k10_ins, True), 20),
           cuda_ms(lambda: raster_planes_plain(*k10_ins, True), 5))
    print(f"phase 2: K4 within rtol/atol 1e-4 at 1080p (sum rule {k4_err:.2e}, given "
          f"colours {e4:.2e}, radius 2 {e2:.2e}) and at the v1 geometry (K10, "
          f"{max(k10_err, e10):.2e})")

    # The whole step on a small input: kernels (card) vs plain versions (CPU).
    small = GridSpec.from_bounds((-90.0, 90.0, -45.0, 45.0), 9.0, 128)
    sp = make_params(bounds=(-90.0, 90.0, -45.0, 45.0), gravity=400.0)
    g2 = torch.Generator(device="cpu").manual_seed(3)
    spos = torch.stack([torch.rand(3000, generator=g2) * 180 - 90,
                        (torch.randn(3000, generator=g2) * 11.25).clamp(-45, 45)], -1)
    sc = R.plane_state_from_particles(port.make_state(spos.cuda()), small)
    sh = R.plane_state_from_particles(port.make_state(spos), small)
    for i in range(9):
        sc, sh = R.plane_step(sc, sp, small), R.plane_step(sh, sp, small)
        if i == 5:  # one live frame
            gc, gh_ = sc.to_particle_state(), sh.to_particle_state()
            require(close(gc.pos.cpu(), gh_.pos, 1e-4, 1e-4)
                    and close(gc.vel.cpu(), gh_.vel, 1e-4, 1e-2),
                    "one live frame: card differs from the plain path")
    gc, gh_ = sc.to_particle_state(), sh.to_particle_state()
    require(int(sc.lost) == 0 and int(sc.live.sum()) == 3000, "small run lost particles")
    require(bool(torch.equal(gc.ids.cpu(), gh_.ids)), "small run ids differ")
    require(max_abs(gc.pos.cpu(), gh_.pos) <= 5e-4 and max_abs(gc.vel.cpu(), gh_.vel) <= 5e-3,
            "4 live frames: card differs from the plain path beyond 5e-4 / 5e-3")
    print("phase 2: whole step, card vs plain (CPU): 1 live frame within 1e-4, "
          f"4 live frames pos {max_abs(gc.pos.cpu(), gh_.pos):.2e} "
          f"vel {max_abs(gc.vel.cpu(), gh_.vel):.2e}")

    # ---------------- phase 3: the user entry points ----------------
    kernels = {"K1": rebin_planes, "K2": density_planes, "K3": force_planes_integrated,
               "K3b": force_planes, "K4": raster_planes, "K5": cell_planes_aos}
    paths = {}

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def read(path):
        paths[path] = {k: fn.launches for k, fn in kernels.items()}
        return paths[path]

    # scene: the reference's default scene, its image, fused frames.
    reset()
    sim = Simulation(SPHFluid.create(n=50_000))
    sim.update_params(gravity=400.0)
    s0 = sim.state
    y_start = float(s0.py[s0.live].mean())
    sim.run(5)
    require(sim.state.frame == 5, "frame counter")
    require(all(torch.equal(getattr(sim.state, f), getattr(s0, f))
                for f in ("px", "py", "vx", "vy", "idsf")), "warm-up frames not frozen")
    t0 = time.perf_counter()
    for _ in range(5):
        sim.run(59)
        st = sim.state
        require(int(st.lost) == 0, "lost particles")
        require(int(st.live.sum()) == 50_000, "live count changed")
        stats = sim.stats()  # finite and in bounds, else raises
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    y_end = float(sim.state.py[sim.state.live].mean())
    require(sim.state.frame == 300, "frame counter")
    require(y_end < y_start - 50.0, f"y centre of mass did not fall ({y_start} -> {y_end})")
    img300 = sim.render()
    require(tuple(img300.shape) == (1080, 1920, 4), f"image shape {tuple(img300.shape)}")
    require(bool(torch.isfinite(img300).all()), "image not finite")
    require(float(img300[..., 3].min()) >= 0.0 and float(img300[..., 3].max()) <= 1.0,
            "image alpha outside [0, 1]")
    covered = int((img300[..., :3].amax(-1) > 0.0).sum())
    require(covered > 50_000, f"only {covered} pixels drawn")
    model = sim.model
    sa = sb = sim.state
    for _ in range(10):
        sa, img = model.step_and_render(sa, sim.params)
        sb = R.plane_step(sb, sim.params, model.grid)
    torch.cuda.synchronize()
    require(sa.frame == sb.frame == 310 and all(
        torch.equal(getattr(sa, f), getattr(sb, f)) for f in ("px", "py", "vx", "vy", "idsf")),
        "step_and_render's state differs from plane_step's")
    require(tuple(img.shape) == (1080, 1920, 4) and bool(torch.isfinite(img).all()),
            "step_and_render image")
    launches = read("scene")
    require(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
            f"a kernel of the scene path never launched: {launches}")
    ms50 = cuda_ms(lambda: sim.run(1), 100)
    print(f"phase 3: 50k x 300 frames ok (lost 0, live 50000, y {y_start:.1f} -> "
          f"{y_end:.1f}, max occupancy {stats['grid_max_occupancy']}); render "
          f"{covered} px drawn; 10 step_and_render frames bit-equal to plane_step; "
          f"launches {launches}; {scene_s:.2f} s host clock incl. stats; "
          f"{ms50:.3f} ms/frame after frame 310 [{card}]")

    # cli: the documented drive command, its PNG against the scene's image.
    png = HERE / "build" / "chip_smoke_50k.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    reset()
    rc = cli.main(["--n", "50000", "--frames", "300", "--set", "gravity=400",
                   "--render", str(png), "--stats"])
    torch.cuda.synchronize()
    launches = read("cli")
    require(rc == 0, f"cli exited {rc}")
    require(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")),
            f"a kernel of the cli path never launched: {launches}")
    got = read_png(png)
    want = to_srgb_u8(img300).cpu().numpy()
    require(got.shape == want.shape == (1080, 1920, 4), f"PNG shape {got.shape}")
    diff = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    require(diff <= 1, f"the CLI's PNG differs from the scene's image by {diff} LSB")
    print(f"phase 3: cli --render {png.name}: {got.shape[1]}x{got.shape[0]} RGBA, "
          f"max {diff} LSB from the scene's frame 300; launches {launches}")

    # unfused: the fused frame with the unfused tail (K3b), as bench tools call it.
    reset()
    su = sim.state
    for _ in range(5):
        su, img = R.plane_frame(su, sim.params, model.grid, model.render_spec,
                                bounds_static=model.bounds, fuse_tail=False)
    torch.cuda.synchronize()
    launches = read("unfused")
    require(launches["K3b"] > 0 and launches["K4"] > 0 and launches["K3"] == 0,
            f"the unfused path did not run K3b/K4 alone: {launches}")
    require(int(su.live.sum()) == 50_000 and bool(torch.isfinite(img).all()),
            "unfused frames lost particles or drew a non-finite image")
    print(f"phase 3: 5 plane_frame(fuse_tail=False) frames ok; launches {launches}")

    # v1: a model whose render geometry JAX sends to its v1 rasterizer (K10).
    reset()
    m1 = SPHFluid.create(n=1500, bounds=v1_bounds, render_spec=v1_rs)
    sim1 = Simulation(m1)
    sim1.update_params(gravity=400.0)
    s1 = sim1.state
    for _ in range(10):
        s1, img1 = m1.step_and_render(s1, sim1.params)
    img1b = m1.render(s1, sim1.params)
    torch.cuda.synchronize()
    launches = read("v1")
    require(launches["K4"] > 0, f"the v1 path never launched the rasterizer: {launches}")
    require(tuple(img1.shape) == (180, 90, 4) and bool(torch.isfinite(img1).all())
            and bool(torch.isfinite(img1b).all()), "v1 images")
    require(int(s1.lost) == 0 and int(s1.live.sum()) == 1500, "v1 run lost particles")
    print(f"phase 3: v1 geometry (90x180 px, 9x36 px cells) 10 step_and_render "
          f"frames ok; launches {launches}")
    for k in ("K1", "K2", "K3", "K4", "K5"):
        rows[k]["launches"] = paths["scene"][k]
    rows["K3b"]["launches"] = paths["unfused"]["K3b"]
    rows["K10"]["launches"] = paths["v1"]["K4"]

    # ---------------- phase 4: 1M uniform, C=128 ----------------
    p4 = make_params(bounds=BOUNDS)
    st = uniform_plane_state(torch, spec, N_1M, seed=7)
    st = dataclasses.replace(st, frame=p4.shader_delay)
    for _ in range(5):
        st = R.plane_step(st, p4, spec)
    torch.cuda.synchronize()
    holder = [st]

    def frame():
        holder[0] = R.plane_step(holder[0], p4, spec)

    def frame_render():
        holder[0], _ = R.plane_frame(holder[0], p4, spec, rs_main, bounds_static=BOUNDS)

    ms1m = cuda_ms(frame, 40)
    ms_render = cuda_ms(lambda: R.render_plane_state(holder[0], p4, spec, rs_main,
                                                     bounds_static=BOUNDS), 40)
    ms_fused = cuda_ms(frame_render, 40)
    require(int(holder[0].lost) == 0 and int(holder[0].live.sum()) == N_1M,
            "1M run lost particles")
    print(f"phase 4: 1M uniform C=128: step {ms1m:.3f} ms/frame "
          f"({N_1M / ms1m * 1e3:,.0f} particle-steps/s), render alone {ms_render:.3f} ms, "
          f"step_and_render {ms_fused:.3f} ms/frame [{card}]")
    order = ("K5", "K1", "K2", "K3", "K3b", "K4", "K10")
    for k in order:
        r = rows[k]
        print(f"phase 4: {r['name']}: {r['ms']:.3f} ms kernel vs {r['plain_ms']:.3f} ms "
              f"plain [{card}]")

    result = {"kernels": [rows[k] for k in order]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            **result, "card": card, "build_s": build_s, "ms_per_frame_50k": ms50,
            "ms_per_frame_1m": ms1m, "ms_render_1m": ms_render,
            "ms_step_and_render_1m": ms_fused, "scene_300_s": scene_s,
            "paths": paths}, indent=1))
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
