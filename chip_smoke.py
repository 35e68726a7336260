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
     C=64 on a small grid); K2 and K3 at the stated tolerances; then the whole
     step against the plain path (CPU) on a small input;
  3  the reference's default scene through the user entry points:
     Simulation(SPHFluid.create(n=50_000)), gravity=400, 300 frames; lost == 0,
     live count exact after every chunk, warm-up frozen, finite, in bounds,
     the y centre of mass falls, and every kernel launched;
  4  1M particles, uniform, C=128: 40 frames timed with CUDA events.

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
        density_planes, density_planes_plain, force_planes_integrated,
        force_planes_integrated_plain, force_scalars, pressure_terms)
    from rust_particle_system_tpu_torch.ops.grid import GridSpec, build_grid
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

    # ---------------- phase 3: the reference's default scene ----------------
    kernels = {"K1": rebin_planes, "K2": density_planes,
               "K3": force_planes_integrated, "K5": cell_planes_aos}
    for fn in kernels.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in kernels.items()}
    require(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    ms50 = cuda_ms(lambda: sim.run(1), 100)
    print(f"phase 3: 50k x 300 frames ok (lost 0, live 50000, y {y_start:.1f} -> "
          f"{y_end:.1f}, max occupancy {stats['grid_max_occupancy']}); launches "
          f"{launches}; {scene_s:.2f} s host clock incl. stats; "
          f"{ms50:.3f} ms/frame after frame 300 [{card}]")
    for k, v in launches.items():
        rows[k]["launches"] = v

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

    ms1m = cuda_ms(frame, 40)
    require(int(holder[0].lost) == 0 and int(holder[0].live.sum()) == N_1M,
            "1M run lost particles")
    print(f"phase 4: 1M uniform C=128: {ms1m:.3f} ms/frame, "
          f"{N_1M / ms1m * 1e3:,.0f} particle-steps/s [{card}]")
    for k in ("K5", "K1", "K2", "K3"):
        r = rows[k]
        print(f"phase 4: {r['name']}: {r['ms']:.3f} ms kernel vs {r['plain_ms']:.3f} ms "
              f"plain at the main-path shape [{card}]")

    result = {"kernels": [rows[k] for k in ("K5", "K1", "K2", "K3")]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            **result, "card": card, "build_s": build_s, "ms_per_frame_50k": ms50,
            "ms_per_frame_1m": ms1m, "scene_300_s": scene_s}, indent=1))
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
