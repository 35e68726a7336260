#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json] [--mesh]

Run from the root of a checkout.  It needs one CUDA card, the CUDA toolkit
(nvcc) and PyTorch; it imports nothing of JAX.  ``--mesh`` runs phases 0 and 1
and the mesh worlds of phase 3 alone; on a host with several cards its NCCL
world then has one rank per card (halos over NVLink).  Phases, one line each:

  0  the device (name, and nvidia-smi's name and power limit);
  1  build every kernel from csrc/ (seconds);
  2  each kernel against its plain PyTorch version on the card, at the
     main-path shape (default 1920x1080 bounds, 9-unit cells: gw=214, gh=121,
     C=128) from a 1M-particle uniform state after a few live frames:
     K5 and K1 bit-equal (K1 also on a state with air rows, and at C=16 and
     C=64 on a small grid); K7 on each of 4 bands of the 1M state on the
     grid padded to 124 rows (and with air rows across a band boundary, and
     8 bands of one row on a small grid) bit-equal to K1's rows and to its
     plain version; K9 (the hole-fill passes of rebin variants 4 and 5) in
     each of its four modes, each whole variant, and variant 5 against K1,
     bit-equal on the same states, and in band mode on the 4 x 31 rows; K12
     (variants 2 and 3) bit-equal, also where counts exceed C; K2, K3 and
     K3b at the stated tolerances; the
     unfused tail (K3b) against the fused one (K3); K4 at rtol/atol 1e-4 on
     the 1080p image of the stepped state (sum rule, given colours, radius 2)
     and at a geometry the JAX package sends to its v1 rasterizer (K10); K6's
     three walks on a 1M uniform pair-packed state (C=64, the JAX package's
     headline configuration, bench.py:387-389) with forced deferrals, at C=32
     and on an odd-width grid, and against K2/K3 on the same C=64 planes; K8
     at n = 16,384 and 1000, coincident particles included; K11 (the
     cell-binned splat) at 1080p, capacity 64, rtol/atol 1e-4 with equal
     overflow, on a 1M uniform state, the 50k scene's state under the camera
     (5, -3, 1.5), a crammed cluster that overflows and particles on the
     edges, off screen and on 8-px cell boundaries (and against the scatter
     splat where nothing overflowed); then the whole step, and the N-body,
     flow and attractor steps, against the plain path (CPU) on small inputs;
     the spec on the card: at n = 4096, grid_step and one live frame of
     plane_step (K1, K2, K3) against the all-pairs reference_step;
     the fast mode's stages (protos.mxu_fast_forces): K14a (moments, 1 and 4
     channels) and K14c (evaluation, 1 and 7 pairs) on its 1M uniform C=64
     state, as its timing modes feed it and with the spilled slots parked,
     at max abs <= 1e-5 x max|plain|; its C=128 contraction forms K14d-f
     (protos.fastmode_c128) at 8,768 cells, the same bar; the whole
     fast_forces on the card against the plain path (CPU) at 30k within
     1e-4 of each output's scale; the toolchain probes K13a/K13b within
     1e-5 x max|plain| of the plain float32 dot and TF32 emulation,
     K13c/K13d/K13e bit-equal;
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
     pack2  Simulation(SPHFluid.create(n=200_000, capacity=64, pack2=True)),
            gravity 300, frames and step_and_render frames: lost == 0, live
            count exact, K6 launched and K2/K3 not;
     pack2_unfused  plane_frame(fuse_tail=False) on that model (K6's raw walk);
     step_v5  plane_step(variant=5) at 1M, 4 frames, each bit-equal to
            variant 6's; K9 launched and K1 not; frame_v5  one
            plane_frame(variant=5), state and image bit-equal to variant 6's;
     step_v4, step_v3, step_v2  the 50k scene, 5 warm-up + 60 live frames of
            plane_step(variant=4|3|2): finite, in bounds, live + lost == n;
            v2's planes bit-equal to v3's; K9 (v4) or K12 (v2, v3) alone;
     nbody, flow, attractor  runtime.cli.main(--model ... --render
            build/chip_smoke_<model>.png --stats); nbody launches K8;
     grid   Simulation(SPHFluid.create(n=50_000, backend="grid")), gravity
            400, GRID_FRAMES frames: no kernel in the step; finite, in bounds,
            stats() passes validate_grid; its 1080p image (scatter splat)
            against splat_cells of its state (K11), overflow printed;
     cli_grid  runtime.cli.main(--backend grid ... --render
            build/chip_smoke_grid.png --stats), the PNG equal to grid's image;
     oracle  SPHFluid.create(n=4096, backend="oracle"), 10 frames, no kernel;
     flow_k11  the flow model at 1M, 10 frames, then splat_cells at 1080p
            (K11 once) against model.render;
     fastmode  protos.mxu_fast_forces.main(["check"]): 30k particles, the
            fast mode against its exact oracle within its bars; K14a and
            K14c twice each, K5 once (the plane init), no other kernel;
     fastmode_c128  protos.fastmode_c128.main(["4"]): K14d-f 5 times each;
     toolchain  tools.toolchain_smoke.main(): every probe passes; K13a and
            K13b twice, K13c, K13d and K13e once;
     mesh_gloo  the band-sharded step (parallel/) in a world of 4 spawned
            ranks on the one card over gloo (halos staged through the host):
            1M C=128 on 4 x 31 rows, 6 frames, 2 with fuse_tail=False (K3b),
            1 make_plane_sharded_frame with its 1080p image; lost 0 and live
            exact after every frame; the gathered planes bit-equal to the
            single-device plane_step, the image within 2.5e-2 of
            render_plane_state; K7 and the walks launched, K1 not;
     mesh_nccl  the same at 1M in an NCCL world of one rank per card;
     mesh_pack2  the same, pair-packed C=64 at 200k over 4 gloo ranks (K6);
     mesh_gloo_v5, mesh_nccl_v5  4 + 1 frames at 1M with rebin_variant=5
            (K9 with ghost rows and the adoption returned), bit-equal to
            the single-device plane_step; K9 launched, K7 and K1 not;
  4  ms per frame, CUDA events: 1M uniform C=128 (the step, the render alone,
     step_and_render); 1M uniform pair-packed C=64 against classic C=64; the
     N-body at 16,384, the flow field at 1M, the attractor at 65,536; the
     variant-5 rebin at 1M stage by stage (events, and device time by the
     profiler), K12, and plane_step at 1M for variants 6, 5 and 4 in turns;
     K11 (splat_cells) beside the scatter splat at 1080p on the 1M flow
     state, the 50k scene and the 50k grid state; grid_step at 50k and
     reference_step at 4096 per frame; the fast mode at 1M (its stages and
     time modes in one call: A, A+B, A+B+C and end to end by events, each
     stage's device time by the profiler, beside the production walks K2 +
     K3 on the same planes).

Each kernel's line holds its time beside its bound: the larger of the bytes it
must move over the H100's HBM rate and the operations this run's data needs
over its FP32 rate.  Any failure raises and the exit code is nonzero.  The line
before the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}.
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
N_NBODY = 16_384  # BASELINE.json config 3
N_ORACLE = 4096  # the all-pairs oracle's [n, n] temporaries stay ~100 MB
GRID_FRAMES = 125  # 5 warm-up + 120 live frames of the grid backend at 50k
CAMERA = (5.0, -3.0, 1.5)  # tests/test_render.py:170

# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
TF32_OPS_S = 495e12  # dense, on the tensor cores
# Operations per evaluation, counted from the kernels' inner loops (a sqrt,
# divide or rsqrt counts as one, an FMA as two): a density pair and a force
# pair (csrc/sph.cu), an N-body pair (csrc/nbody.cu), and a (slot, pixel) of
# the rasterizer with nch accumulators (csrc/splat_planes.cu).
OPS_DENSITY_PAIR = 12
OPS_FORCE_PAIR = 32
OPS_NBODY_PAIR = 20


def ops_raster(nch: int) -> int:
    return 15 + 2 * nch


def ops_cheb(nb: int) -> int:
    """A slot's u and v (6 operations each) and their nb Chebyshev values
    (2t once, then a multiply and a subtract per term) in the fast-mode
    kernels (csrc/fast_forces.cu)."""
    return 2 * (6 + 1 + 2 * (nb - 2))


def bound(nbytes: float, ops: float, ops_rate: float = FP32_OPS_S) -> tuple:
    """(ms, what bounds it): the least time the card could take, the larger of
    the bytes over the HBM rate and the operations over their type's rate
    (FP32 unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_pairs(walk_px) -> int:
    """Live (own, neighbour) slot pairs over the 3x3 cell windows of walk
    position planes: the pair work a walk needs on them."""
    import torch.nn.functional as F

    n = (walk_px < 5e5).sum(-1).double()
    gh, gw = n.shape
    p = F.pad(n, (1, 1, 1, 1))
    w = sum(p[dy: dy + gh, dx: dx + gw] for dy in range(3) for dx in range(3))
    return int((n * w).sum())


def sprite_pixels(cx, cy, radius: float, height: int, width: int) -> int:
    """(sprite, pixel) pairs a splat must evaluate: the pixel centres of the
    height x width image within ``radius`` of each sprite centre ``cx, cy``
    ([m] pixels; alpha is 0 at and beyond the radius)."""
    import torch

    k = int(radius) + 2
    offs = torch.arange(-k, k + 1, dtype=torch.float32, device=cx.device)
    ix = torch.floor(cx)[:, None] + offs  # [m, 2k + 1] candidate columns
    dx = ix + 0.5 - cx[:, None]
    in_x = (ix >= 0) & (ix < width)
    pairs = 0
    for o in range(-k, k + 1):
        iy = torch.floor(cy) + o
        dy = iy + 0.5 - cy
        in_y = (iy >= 0) & (iy < height)
        pairs += int((in_x & in_y[:, None] & (dx * dx + (dy * dy)[:, None]
                                              < radius * radius)).sum())
    return pairs


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def render_occupancy(torch, pos, bounds, rs, capacity: int = 64, camera=None) -> tuple:
    """(most particles in one 8 x 8-pixel render cell, particles beyond
    ``capacity``) of K11's binning, counted without a kernel."""
    from rust_particle_system_tpu_torch.render import world_to_pixel
    from rust_particle_system_tpu_torch.render.splat_cells import render_grid

    px, py, _, _ = world_to_pixel(pos, bounds, rs, camera)
    keys = render_grid(rs, capacity).cell_keys(torch.stack([px, py], -1))
    counts = torch.bincount(keys.long())
    return int(counts.max()), int((counts - capacity).clamp_min(0).sum())


def spec_close(got, want) -> bool:
    """The JAX tests' one-frame bars against the oracle (tests/test_grid.py:
    103-105, tests/test_pallas_sph.py:38-40): pos rtol/atol 1e-4, vel rtol
    1e-4 / atol 1e-2, colour 1e-3."""
    return (close(got.pos, want.pos, 1e-4, 1e-4) and close(got.vel, want.vel, 1e-4, 1e-2)
            and close(got.color, want.color, 1e-3, 1e-3))


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by its row key (each counts its
    launches in ``.launches``)."""
    from rust_particle_system_tpu_torch.ops.cuda.nbody import nbody_accel
    from rust_particle_system_tpu_torch.ops.cuda.plane_build import cell_planes_aos
    from rust_particle_system_tpu_torch.ops.cuda.rebin import (
        hole_fill_pass, rebin_compact, rebin_planes, rebin_planes_band)
    from rust_particle_system_tpu_torch.ops.cuda.sph import (
        density_pairs, density_planes, force_pairs, force_pairs_integrated, force_planes,
        force_planes_integrated)
    from rust_particle_system_tpu_torch.ops.cuda.fast_forces import evaluate, moments
    from rust_particle_system_tpu_torch.ops.cuda.fastmode_c128 import a_dot, a_vpu, c_vpu
    from rust_particle_system_tpu_torch.ops.cuda.toolchain_probe import (
        bf16_broadcast, bf16_outer, copy_ids, dot_f32, dot_tf32)
    from rust_particle_system_tpu_torch.render.splat_cells import raster_cells
    from rust_particle_system_tpu_torch.render.splat_planes import raster_planes

    return {"K1": rebin_planes, "K2": density_planes, "K3": force_planes_integrated,
            "K3b": force_planes, "K4": raster_planes, "K5": cell_planes_aos,
            "K6d": density_pairs, "K6f": force_pairs_integrated, "K6r": force_pairs,
            "K7": rebin_planes_band, "K8": nbody_accel, "K9": hole_fill_pass,
            "K11": raster_cells, "K12": rebin_compact, "K13a": dot_f32, "K13b": dot_tf32,
            "K13c": copy_ids, "K13d": bf16_broadcast, "K13e": bf16_outer, "K14a": moments,
            "K14c": evaluate, "K14d": a_dot, "K14e": a_vpu, "K14f": c_vpu}


def band_state(n: int, capacity: int, pack2: bool, n_bands: int, seed: int, device):
    """(grid, params, whole PlaneState) of n uniform particles (numpy, from
    ``seed``) on the default grid padded to ``n_bands``, past the warm-up:
    C=128 under gravity 400, or pair-packed C=64 under gravity 300."""
    import numpy as np
    import torch

    from rust_particle_system_tpu_torch.core.params import make_params
    from rust_particle_system_tpu_torch.core.state import make_state
    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.parallel import make_shard_spec

    spec = make_shard_spec(BOUNDS, 9.0, capacity, n_bands, pack2=pack2)
    params = make_params(bounds=BOUNDS, gravity=300.0 if pack2 else 400.0)
    u = np.random.default_rng(seed).random((n, 2), dtype=np.float32)
    lo, hi = np.float32([BOUNDS[0], BOUNDS[2]]), np.float32([BOUNDS[1], BOUNDS[3]])
    pos = torch.as_tensor(lo + u * (hi - lo), device=device)
    whole = R.plane_state_from_particles(make_state(pos), spec)
    require(int(whole.lost) == 0, f"{n} particles did not fit the grid")
    return spec, params, dataclasses.replace(whole, frame=params.shader_delay)


def mesh_rank(mesh, n: int, capacity: int, pack2: bool, frames: int, unfused: int,
              render: bool, seed: int, rebin_variant: int) -> dict:
    """One band of a sharded world (run by run_bands, one process per band):
    the whole n-particle uniform state on the grid padded to the bands, built
    alike on every rank from ``seed``; then, with the launch counts set to 0,
    ``frames`` sharded steps, ``unfused`` more with fuse_tail=False and, with
    ``render``, one sharded frame with its 1080p image, the diagnostics read
    after each (lost 0, live count exact).  Band 0 then holds the gathered
    planes to the single-device plane_step from the same state, bit for bit,
    and the image to render_plane_state of it at atol 2.5e-2.  Both run the
    rebin ``rebin_variant`` (6: K7 on the bands, 5: K9's passes)."""
    import torch

    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.parallel import (
        check_plane_diags, gather_plane_state, make_plane_sharded_frame,
        make_plane_sharded_step, shard_plane_state)
    from rust_particle_system_tpu_torch.render import RenderSpec

    require("jax" not in sys.modules, "a rank imported jax")
    spec, params, whole = band_state(n, capacity, pack2, mesh.size, seed, mesh.device)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    slab = shard_plane_state(whole, mesh)
    ms, render_ms = [], None
    for fuse_tail, count in ((True, frames), (False, unfused)):
        step = make_plane_sharded_step(spec, mesh, rebin_variant, fuse_tail)
        for _ in range(count):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slab, diags = step(slab, params)
            check_plane_diags(diags, n)  # reads the diagnostics back
            ms.append((time.perf_counter() - t0) * 1e3)
    if render:
        rs = RenderSpec()
        frame = make_plane_sharded_frame(spec, mesh, rs, BOUNDS, rebin_variant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slab, image, diags = frame(slab, params)
        check_plane_diags(diags, n)
        render_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out = {"launches": {k: fn.launches for k, fn in counters.items()},
           "ms_per_frame": ms, "ms_frame_with_image": render_ms,
           "device": str(mesh.device), "rows": spec.gh // mesh.size}
    got = gather_plane_state(slab, mesh)
    require(int(got.lost) == 0 and int(got.live.sum()) == n, "the sharded run lost particles")
    if mesh.rank:
        return out
    ref = whole
    for fuse_tail, count in ((True, frames), (False, unfused), (True, int(render))):
        for _ in range(count):
            ref = R.plane_step(ref, params, spec, fuse_tail, rebin_variant)
    require(got.frame == ref.frame and all(
        torch.equal(getattr(got, f), getattr(ref, f)) for f in ("px", "py", "vx", "vy", "idsf")),
        f"{mesh.size} bands ({mesh.backend}): the gathered planes differ from the "
        "single-device plane_step")
    if render:
        want = R.render_plane_state(ref, params, spec, rs, bounds_static=BOUNDS)
        require(tuple(image.shape) == (1080, 1920, 4) and close(image, want, 0.0, 2.5e-2),
                "the sharded frame's image differs from render_plane_state beyond 2.5e-2")
        out["image_err"] = max_abs(image, want)
    return out


def mesh_worlds(paths: dict, card: str) -> dict:
    """The band-sharded mesh's worlds of spawned ranks (parallel.run_bands):
    4 ranks over gloo on card 0 (1M C=128, and pair-packed 200k), and one
    rank per card over NCCL (1M); then both 1M worlds again with rebin
    variant 5.  Each rank counts its own launches, set to 0
    just before its path; ``paths`` gets the sums over the ranks.  Returns
    each world's timings.  gloo stages every halo and all_reduce through the
    host: its times are not NVLink times."""
    import torch

    from rust_particle_system_tpu_torch.parallel import run_bands

    mesh_ms = {}
    cards = torch.cuda.device_count()
    for label, n_bands, backend, margs in (
            ("mesh_gloo", 4, "gloo", (N_1M, 128, False, 6, 2, True, 21, 6)),
            ("mesh_nccl", cards, "nccl", (N_1M, 128, False, 6, 2, True, 22, 6)),
            ("mesh_pack2", 4, "gloo", (200_000, 64, True, 6, 2, False, 23, 6)),
            ("mesh_gloo_v5", 4, "gloo", (N_1M, 128, False, 4, 1, False, 24, 5)),
            ("mesh_nccl_v5", cards, "nccl", (N_1M, 128, False, 4, 1, False, 25, 5))):
        t0 = time.perf_counter()
        res = run_bands(mesh_rank, n_bands, backend, "cuda", timeout=400.0, args=margs)
        world_s = time.perf_counter() - t0
        launches = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
        paths[label] = launches
        frames = margs[3] + margs[4] + int(margs[5])
        walks = ("K6d", "K6f", "K6r") if margs[2] else ("K2", "K3", "K3b")
        rebins = ({"K7": n_bands * frames, "K9": 0} if margs[7] == 6
                  else {"K7": 0, "K9": 2 * n_bands * frames})
        require(all(launches[k] == v for k, v in rebins.items()) and launches["K1"] == 0
                and launches["K12"] == 0 and all(launches[k] > 0 for k in walks)
                and launches["K4"] == n_bands * int(margs[5]),
                f"{label}: the sharded path did not run its rebin ({rebins}) and its walks "
                f"alone: {launches}")
        ms = [max(r["ms_per_frame"][i] for r in res) for i in range(margs[3] + margs[4])]
        mesh_ms[label] = {"transport": backend, "bands": n_bands, "rows": res[0]["rows"],
                          "n": margs[0], "ms_per_frame": ms,
                          "ms_frame_with_image": res[0]["ms_frame_with_image"],
                          "world_s": world_s}
        err = res[0].get("image_err")
        print(f"phase 3: {label}: {n_bands} band(s) x {res[0]['rows']} rows over {backend}, "
              f"rebin variant {margs[7]} "
              f"({'host-staged halos, ' if backend == 'gloo' else ''}on "
              f"{', '.join(sorted({r['device'] for r in res}))}), {margs[0]} particles, "
              f"{margs[3]} + {margs[4]} unfused frames{' + 1 with its image' if margs[5] else ''}: "
              f"lost 0, live exact each frame; gathered planes bit-equal to the single-device "
              f"plane_step{f'; image within 2.5e-2 ({err:.2e})' if err is not None else ''}; "
              f"launches {launches}; ms/frame ({backend}) {[round(m, 3) for m in ms]}, "
              f"with image {res[0]['ms_frame_with_image']}; world {world_s:.1f} s [{card}]")
    return mesh_ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results here (JSON)")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the device, build and band-sharded mesh phases "
                         "(its NCCL world takes every card)")
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
        hole_fill_pass, hole_fill_pass_plain, rebin_compact, rebin_compact_plain,
        rebin_planes, rebin_planes_band, rebin_planes_band_plain, rebin_planes_plain,
        retention_merge)
    from rust_particle_system_tpu_torch.models import MODEL_FAMILIES
    from rust_particle_system_tpu_torch.models.nbody import make_nbody_params
    from rust_particle_system_tpu_torch.ops.cuda.nbody import nbody_accel, nbody_accel_plain
    from rust_particle_system_tpu_torch.ops.cuda.sph import (
        density_pairs, density_planes, density_planes_plain, density_scalars,
        force_pairs, force_pairs_integrated, force_planes, force_planes_integrated,
        force_planes_integrated_plain, force_planes_plain, force_scalars,
        pressure_terms)
    from rust_particle_system_tpu_torch.ops.grid import GridSpec, build_grid
    from rust_particle_system_tpu_torch.ops.grid_step import grid_physics, grid_step
    from rust_particle_system_tpu_torch.ops.reference_step import reference_step
    from rust_particle_system_tpu_torch.parallel import make_shard_spec
    from rust_particle_system_tpu_torch.render import RenderSpec, splat, to_srgb_u8
    from rust_particle_system_tpu_torch.render.splat_cells import (
        raster_cells, raster_cells_inputs, raster_cells_plain, splat_cells, splat_cells_plain)
    from rust_particle_system_tpu_torch.render.splat_planes import (
        FAR, drifted_patch_margin, raster_inputs, raster_planes, raster_planes_plain)
    from rust_particle_system_tpu_torch.ops.cuda import fast_forces as K14
    from rust_particle_system_tpu_torch.ops.cuda import toolchain_probe as K13
    from rust_particle_system_tpu_torch.ops.cuda import fastmode_c128 as K14dF
    from rust_particle_system_tpu_torch.protos import fastmode_c128 as C128
    from rust_particle_system_tpu_torch.protos import mxu_fast_forces as FF
    from rust_particle_system_tpu_torch.runtime import cli
    from rust_particle_system_tpu_torch.runtime.profiling import device_ms
    from rust_particle_system_tpu_torch.runtime.simulation import Simulation
    from rust_particle_system_tpu_torch.runtime.timing import cuda_ms
    from rust_particle_system_tpu_torch.tools import toolchain_smoke as smoke

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
    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    if args.mesh:
        paths = {}
        print(json.dumps({"mesh": mesh_worlds(paths, card), "paths": paths}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    # ---------------- phase 2: kernels vs plain, main-path shape ----------------
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 128)
    require((spec.gw, spec.gh) == (214, 121), f"unexpected grid {spec}")
    params = make_params(bounds=BOUNDS, gravity=400.0)
    rows = {}

    def record(key, name, source, replaces, err, ms, plain_ms, moved, ops, library_ms=None,
               ops_rate=FP32_OPS_S):
        """One kernel's line; ``moved`` bytes and ``ops`` operations (at
        ``ops_rate``) set its bound.  ``library_ms`` is the time of one
        PyTorch call computing the same function, where there is one (K13,
        K14); no single call computes K1-K12's, so theirs is null."""
        bound_ms, bound_by = bound(moved, ops, ops_rate)
        rows[key] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}

    # K5 on the 1M uniform binning.
    gen = torch.Generator(device="cuda").manual_seed(1)
    u = torch.rand((N_1M, 2), generator=gen, device="cuda")
    lo = torch.tensor([BOUNDS[0], BOUNDS[2]], device="cuda")
    hi = torch.tensor([BOUNDS[1], BOUNDS[3]], device="cuda")
    pos = lo + u * (hi - lo)
    grid = build_grid(spec, pos, with_table=False)
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
           cuda_ms(lambda: cell_planes_aos_plain(*args5), 5),
           nbytes(packed, grid.starts, a), 0)
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
           cuda_ms(lambda: rebin_planes_plain(rin, spec), 5),
           nbytes(*rin, *a, ca), 0)
    print("phase 2: K1 bit-equal (1M stepped, air rows, C=16 and C=64 x drift 0.4/0.9/1.8)")

    # K7: the 1M state on the grid padded to 4 bands (gh 121 -> 124, 31 rows
    # each), a few frames in; each band's K7 (ghost rows from the neighbour
    # bands, zeros past the grid's edges) against K1's rows of the whole grid
    # and against its plain version, with and without air rows; then 8 bands
    # of one row on a small grid.
    def check_k7(label, planes, sp, n_bands):
        full, cfull = rebin_planes(planes, sp)
        Rb = sp.gh // n_bands
        zeros = torch.zeros_like(planes[0][0])
        row = lambda c, r: planes[c][r] if 0 <= r < sp.gh else zeros
        calls, err = [], 0.0
        for b in range(n_bands):
            r0 = b * Rb
            args7 = ([p[r0:r0 + Rb] for p in planes], sp, fills, r0,
                     [row(c, r0 - 2) for c in (0, 1)],
                     [row(c, r0 - 1) for c in range(5)], [row(c, r0 + Rb) for c in range(5)])
            x, cx = rebin_planes_band(*args7)
            y, cy = rebin_planes_band_plain(*args7)
            rows_b = slice(r0, r0 + Rb)
            require(all(torch.equal(p, q) and torch.equal(p, f[rows_b])
                        for p, q, f in zip(x, y, full))
                    and torch.equal(cx, cy) and torch.equal(cx, cfull[r0 * sp.gw:(r0 + Rb) * sp.gw]),
                    f"K7 band {b} of {n_bands} ({label}) differs from K1's rows or its plain "
                    "version")
            calls.append((args7, x, cx))
            err = max([err] + [max_abs(p, q) for p, q in zip(x, y)])
        return calls, err

    spec7 = make_shard_spec(BOUNDS, 9.0, 128, 4)
    require((spec7.gw, spec7.gh) == (214, 124), f"unexpected padded grid {spec7}")
    ps7 = R.plane_state_from_particles(port.make_state(pos), spec7)
    ps7 = dataclasses.replace(ps7, frame=params.shader_delay)
    for _ in range(3):
        ps7 = R.plane_step(ps7, params, spec7)
    rin7 = R.predict_planes(ps7, params)
    k7_calls, k7_err = check_k7("1M stepped", rin7, spec7, 4)
    air7 = [p.clone() for p in rin7]
    for c, p in enumerate(air7):
        p[29:33] = 1e6 if c < 2 else 0.0  # air across the boundary of bands 0 and 1
    check_k7("air rows", air7, spec7, 4)
    small8 = GridSpec(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=8, capacity=16)
    for drift in (0.4, 0.9, 1.8):
        check_k7(f"R=1, drift {drift}", demo_planes(torch, small8, 0.7, drift, seed=80,
                                                    device="cuda"), small8, 8)
    args7, out7, cnt7 = k7_calls[1]  # an inner band
    record("K7", "K7 band rebin (31 of 124 rows)", "rust_particle_system_tpu_torch/csrc/rebin.cu",
           "rust_particle_system_tpu/ops/pallas/rebin.py:765", k7_err,
           cuda_ms(lambda: rebin_planes_band(*args7), 20),
           cuda_ms(lambda: rebin_planes_band_plain(*args7), 5),
           nbytes(*args7[0], *args7[4], *args7[5], *args7[6], *out7, cnt7), 0)
    print("phase 2: K7 bit-equal to K1's rows and to its plain version (1M on 4 x 31 rows, "
          "air rows across a band boundary, 8 bands x 1 row x drift 0.4/0.9/1.8)")

    # K9: the separable hole-fill pass of rebin variants 4 and 5, in each of
    # its four modes (pass Y / pass X, lossy / lossless) against its plain
    # version on the same planes; each whole variant against its plain chain
    # (the same torch merges around the plain passes); variant 5 against K1.
    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    def check_k9(label, planes, sp):
        nc, C = sp.num_cells, sp.capacity
        flats = [p.reshape(nc, C) for p in planes]
        for shift, row_only in ((sp.gw, True), (1, False)):
            for lossless in (False, True):
                x = hole_fill_pass(flats, sp, fills, shift, row_only, lossless)
                y = hole_fill_pass_plain(flats, sp, fills, shift, row_only, lossless)
                require(same(x[0], y[0]) and torch.equal(x[1], y[1])
                        and (x[2] is None if y[2] is None else torch.equal(x[2], y[2])),
                        f"K9 ({label}, shift {shift}, lossless {lossless}) differs from its "
                        "plain version")
        for v in (4, 5):
            x, cx = rebin_planes(planes, sp, variant=v)
            y, cy = rebin_planes_plain(planes, sp, variant=v)
            require(same(x, y) and torch.equal(cx, cy),
                    f"rebin variant {v} ({label}) differs from its plain version")
        x, cx = rebin_planes(planes, sp, variant=5)
        y, cy = rebin_planes(planes, sp, variant=6)
        require(same(x, y) and torch.equal(cx, cy), f"K9's variant 5 ({label}) differs from K1")

    check_k9("1M stepped", rin, spec)
    check_k9("air rows", air, spec)
    for C in (16, 64):
        small = GridSpec(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7, capacity=C)
        for drift in (0.4, 0.9, 1.8):
            check_k9(f"C={C}, drift {drift}",
                     demo_planes(torch, small, 0.7, drift, seed=C + int(10 * drift),
                                 device="cuda"), small)
    # K9's band mode (the sharded step's variant 5): pass Y on each 31-row
    # band of the padded 1M state with the neighbour rows as ghost rows (the
    # fills past the grid, as the mesh gives them), then pass X band-local.
    for b in range(4):
        r0, rb = 31 * b, 31
        nb = rb * spec7.gw
        fill_row = lambda c: torch.full_like(rin7[c][0], fills[c])
        ghosts = [(rin7[c][r0 - 1] if r0 else fill_row(c),
                   rin7[c][r0 + rb] if r0 + rb < spec7.gh else fill_row(c)) for c in range(5)]
        bflats = [p[r0:r0 + rb].reshape(nb, 128) for p in rin7]
        for args9 in ((bflats, spec7, fills, spec7.gw, True, True, ghosts, r0),
                      (bflats, spec7, fills, 1, False, True, None, r0)):
            x, y = hole_fill_pass(*args9), hole_fill_pass_plain(*args9)
            require(same(x[0], y[0]) and torch.equal(x[1], y[1]) and torch.equal(x[2], y[2]),
                    f"K9 band mode (band {b}, shift {args9[3]}) differs from its plain version")
    # Its row: one variant-5 rebin's two passes on the 1M stepped state.
    nc1 = spec.num_cells
    flats1 = [p.reshape(nc1, 128) for p in rin]
    passY = (flats1, spec, fills, spec.gw, True, True)
    midY, _, accY = hole_fill_pass(*passY)
    mergedY = retention_merge(flats1, midY, accY, spec, spec.gw, True)
    passX = (mergedY, spec, fills, 1, False, True)
    outX, cntX, accX = hole_fill_pass(*passX)
    k9_err = max(max_abs(x, y) for x, y in zip(
        midY + outX, hole_fill_pass_plain(*passY)[0] + hole_fill_pass_plain(*passX)[0]))
    record("K9", "K9 hole-fill passes Y + X (variant 5)",
           "rust_particle_system_tpu_torch/csrc/rebin_pass.cu",
           "rust_particle_system_tpu/ops/pallas/rebin.py:190", k9_err,
           cuda_ms(lambda: hole_fill_pass(*passY), 20) + cuda_ms(lambda: hole_fill_pass(*passX), 20),
           cuda_ms(lambda: hole_fill_pass_plain(*passY), 5)
           + cuda_ms(lambda: hole_fill_pass_plain(*passX), 5),
           nbytes(*flats1, *midY, accY, *mergedY, *outX, cntX, accX) + 4 * nc1, 0)
    print("phase 2: K9 bit-equal to its plain version in its four modes and as variants 4 "
          "and 5, variant 5 bit-equal to K1 (1M stepped, air rows, C=16 and C=64 x drift "
          "0.4/0.9/1.8), and in band mode on 4 x 31 rows of the padded 1M state")

    # K12: the full-window compaction of variants 2 and 3, both routed to it;
    # the same states, and a crowded small grid whose counts exceed C.
    def check_k12(label, planes, sp):
        x, cx = rebin_compact(planes, sp)
        y, cy = rebin_compact_plain(planes, sp, fills)
        require(same(x, y) and torch.equal(cx, cy),
                f"K12 ({label}) differs from its plain version")
        for v in (2, 3):
            z, cz = rebin_planes(planes, sp, variant=v)
            require(same(x, z) and torch.equal(cx, cz), f"variant {v} ({label}) is not K12's")
        return cx

    check_k12("1M stepped", rin, spec)
    check_k12("air rows", air, spec)
    for C in (16, 64):
        small = GridSpec(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7, capacity=C)
        for drift in (0.4, 0.9, 1.8):
            check_k12(f"C={C}, drift {drift}",
                      demo_planes(torch, small, 0.7, drift, seed=C + int(10 * drift),
                                  device="cuda"), small)
    small16 = GridSpec(x_min=-90.0, y_min=-45.0, cell_size=9.0, gw=11, gh=7, capacity=16)
    crowd = check_k12("crowded", demo_planes(torch, small16, 0.95, 1.8, seed=95,
                                             device="cuda"), small16)
    require(int(crowd.max()) > 16, f"the crowded grid never overflowed ({int(crowd.max())})")
    k12_out, k12_cnt = rebin_compact(rin, spec)
    k12_err = max(max_abs(x, y) for x, y in zip(k12_out, rebin_compact_plain(rin, spec, fills)[0]))
    record("K12", "K12 full-window compaction (variants 2, 3)",
           "rust_particle_system_tpu_torch/csrc/rebin_compact.cu",
           "rust_particle_system_tpu/ops/pallas/rebin.py:124", k12_err,
           cuda_ms(lambda: rebin_compact(rin, spec), 20),
           cuda_ms(lambda: rebin_compact_plain(rin, spec, fills), 3),
           nbytes(*rin, *k12_out, k12_cnt), 0)
    print(f"phase 2: K12 bit-equal to its plain version and as variants 2 and 3 (1M stepped, "
          f"air rows, C=16 and C=64 x drift 0.4/0.9/1.8, crowded: counts up to "
          f"{int(crowd.max())} > C=16)")

    npx, npy, nvx0, nvy0, _ = a

    # The walks' checks, shared by K2/K3/K3b and K6 (``pair``).  Bars: density
    # rtol 1e-5 on walk-live slots and 0 at parked ones; the fused walk's
    # positions rtol/atol 1e-4 and velocities rtol 1e-4 / atol 1e-2, dead and
    # deferred slots bit-equal; the raw walk through the velocity update it
    # feeds at the velocity bars, parked walk slots bit-equal.
    def check_density(label, kernel, wx, wy, prm, pair=False):
        ko = kernel(wx, wy, prm)
        po = density_planes_plain(wx, wy, *density_scalars(prm), pair=pair)
        wl = wx < 5e5
        require(all(close(k, q, 1e-5, 0.0, wl) for k, q in zip(ko, po)),
                f"{label} density differs from its plain version beyond rtol 1e-5")
        require(bool(torch.all(ko[0][~wl] == 0)), f"{label} wrote nonzero parked slots")
        return ko, max(max_abs(k, q, wl) for k, q in zip(ko, po))

    def fused_inputs(density, qx, qy, qvx, qvy, sp, prm):
        """The fused walk's inputs for true positions (qx, qy) resident in
        their slots of grid ``sp``."""
        wx, wy = R.walk_positions(qx, qy, sp)
        P1, NPo, NPn = pressure_terms(*density(wx, wy, prm), prm)
        return (wx, wy, P1, NPn, qvx, qvy, NPo, qx, qy)

    def check_fused(label, kernel, fargs, prm, pair=False):
        ko = kernel(*fargs, prm)
        po = force_planes_integrated_plain(*fargs, force_scalars(prm), pair=pair)
        live = fargs[7] < 5e5
        require(close(ko[0], po[0], 1e-4, 1e-4, live)
                and close(ko[1], po[1], 1e-4, 1e-4, live),
                f"{label} positions differ from the plain version beyond rtol/atol 1e-4")
        require(close(ko[2], po[2], 1e-4, 1e-2, live)
                and close(ko[3], po[3], 1e-4, 1e-2, live),
                f"{label} velocities differ from the plain version beyond rtol 1e-4 / "
                "atol 1e-2")
        require(all(torch.equal(x[~live], y[~live]) for x, y in zip(ko, po)),
                f"{label} dead slots not parked identically")
        deferred = live & ~(fargs[0] < 5e5)
        require(all(torch.equal(x[deferred], y[deferred]) for x, y in zip(ko, po)),
                f"{label} deferred slots differ from the plain version")
        return max(max_abs(x, y, live) for x, y in zip(ko, po)), int(deferred.sum())

    def check_raw(label, kernel, fargs, prm, pair=False):
        scal = force_scalars(prm)
        kraw = kernel(*fargs[:7], prm)
        praw = force_planes_plain(*fargs[:7], scal, pair=pair)
        wl = fargs[0] < 5e5
        err = 0.0
        for v, fi, fvi in ((fargs[4], 0, 2), (fargs[5], 1, 3)):
            kv = v + kraw[fi] * scal[2] + kraw[fvi] * scal[3]
            pv = v + praw[fi] * scal[2] + praw[fvi] * scal[3]
            require(close(kv, pv, 1e-4, 1e-2, wl),
                    f"{label} velocity update differs from the plain version beyond "
                    "rtol 1e-4 / atol 1e-2")
            err = max(err, max_abs(kv, pv, wl))
        require(all(torch.equal(x[~wl], y[~wl]) for x, y in zip(kraw, praw)),
                f"{label} parked walk slots differ from the plain version")
        return err

    def forced_deferrals(qx, sp, seed):
        """5% of live slots keyed two cells to the right of their resident
        cell: the epilogue must restore and integrate them."""
        g = torch.Generator(device="cuda").manual_seed(seed)
        pick = (qx < 5e5) & (torch.rand(qx.shape, generator=g, device="cuda") < 0.05)
        return torch.where(pick, (qx + 2 * sp.cell_width).clamp(max=BOUNDS[1]), qx)

    fpx, fpy = R.walk_positions(npx, npy, spec)
    (rho, rhon), k2_err = check_density("K2", density_planes, fpx, fpy, params)
    pairs_1m = window_pairs(fpx)
    record("K2", "K2 density walk", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", k2_err,
           cuda_ms(lambda: density_planes(fpx, fpy, params), 20),
           cuda_ms(lambda: density_planes_plain(fpx, fpy, *density_scalars(params)), 2),
           nbytes(fpx, fpy, rho, rhon), pairs_1m * OPS_DENSITY_PAIR)
    print(f"phase 2: K2 within rtol 1e-5 on {int((fpx < 5e5).sum())} walk slots")

    fargs = fused_inputs(density_planes, npx, npy, nvx0, nvy0, spec, params)
    k3_err, _ = check_fused("K3", force_planes_integrated, fargs, params)
    far_x = forced_deferrals(npx, spec, 5)
    k3_err_d, n_def = check_fused(
        "K3", force_planes_integrated,
        fused_inputs(density_planes, far_x, npy, nvx0, nvy0, spec, params), params)
    require(n_def > 10_000, f"too few deferred slots ({n_def})")
    record("K3", "K3 force walk + tail", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", max(k3_err, k3_err_d),
           cuda_ms(lambda: force_planes_integrated(*fargs, params), 20),
           cuda_ms(lambda: force_planes_integrated_plain(*fargs, force_scalars(params)), 2),
           nbytes(*fargs) + nbytes(*fargs[:4]), window_pairs(fargs[0]) * OPS_FORCE_PAIR)
    print("phase 2: K3 within pos 1e-4, vel rtol 1e-4 / atol 1e-2; deferred slots "
          f"bit-equal ({n_def} forced)")

    # K3b: the raw walk on K3's inputs.
    bargs = fargs[:7]
    k3b_err = check_raw("K3b", force_planes, fargs, params)
    record("K3b", "K3b force walk, raw sums", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", k3b_err,
           cuda_ms(lambda: force_planes(*bargs, params), 20),
           cuda_ms(lambda: force_planes_plain(*bargs, force_scalars(params)), 2),
           nbytes(*bargs) + nbytes(*bargs[:4]), window_pairs(bargs[0]) * OPS_FORCE_PAIR)
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

    def k4_work(ins) -> tuple:
        """(bytes, operations) of one K4 call (drift clamped): its planes in,
        its accumulators out, and each live sprite, its centre clamped into
        its cell's patch, over the image's pixel centres within its radius."""
        ppx, ppy, cols, (H, W, sx, sy, m), scal = ins
        nch, r = len(cols) + 1, scal[0]
        gh, gw, _ = ppx.shape
        x0 = (torch.arange(gw, device=ppx.device) * sx - m).float()[None, :, None]
        y0 = (H - (torch.arange(gh, device=ppx.device) + 1) * sy - m).float()[:, None, None]
        live = ppx < 0.5 * FAR
        cx = (x0 + (ppx - x0).clamp(r, sx + 2 * m - r))[live]
        cy = (y0 + (ppy - y0).clamp(r, sy + 2 * m - r))[live]
        return (nbytes(ppx, ppy, *cols) + 4 * nch * H * W,
                sprite_pixels(cx, cy, r, H, W) * ops_raster(nch))

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
           cuda_ms(lambda: raster_planes_plain(*k4_ins, True), 2), *k4_work(k4_ins))
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
           cuda_ms(lambda: raster_planes_plain(*k10_ins, True), 5), *k4_work(k10_ins))
    print(f"phase 2: K4 within rtol/atol 1e-4 at 1080p (sum rule {k4_err:.2e}, given "
          f"colours {e4:.2e}, radius 2 {e2:.2e}) and at the v1 geometry (K10, "
          f"{max(k10_err, e10):.2e})")

    # K6 on the JAX package's headline configuration (bench.py:387-389): 1M
    # uniform particles, capacity 64, pair-packed, gravity 300, shader_delay 0,
    # a few frames in.  Its three walks against their plain versions (which
    # walk the TPU's 3x4 pair window), then against K2/K3 on the same planes
    # of the classic C=64 layout.
    spec2 = GridSpec.from_bounds(BOUNDS, 9.0, 64, pack2=True)
    classic64 = dataclasses.replace(spec2, pack2=False)
    p2 = make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
    ps2 = uniform_plane_state(torch, spec2, N_1M, seed=2)
    for _ in range(3):
        ps2 = R.plane_step(ps2, p2, spec2)
    require(int(ps2.lost) == 0 and int(ps2.live.sum()) == N_1M, "1M pack2 state lost particles")
    (qx, qy, qvx, qvy, _), _ = rebin_planes(R.predict_planes(ps2, p2), spec2)
    wx, wy = R.walk_positions(qx, qy, spec2)
    (rho2, rhon2), k6d_err = check_density("K6", density_pairs, wx, wy, p2, pair=True)
    fargs2 = fused_inputs(density_pairs, qx, qy, qvx, qvy, spec2, p2)
    k6f_err, _ = check_fused("K6", force_pairs_integrated, fargs2, p2, pair=True)
    k6f_err_d, n_def2 = check_fused(
        "K6", force_pairs_integrated,
        fused_inputs(density_pairs, forced_deferrals(qx, spec2, 6), qy, qvx, qvy, spec2, p2),
        p2, pair=True)
    require(n_def2 > 10_000, f"too few deferred slots ({n_def2})")
    k6r_err = check_raw("K6", force_pairs, fargs2, p2, pair=True)
    # Small grids: C=32, and an odd width (cell 9.5 = smoothing radius 9.5:
    # gw=21, the last pair's second cell outside the grid), from drifted demo
    # planes whose out-of-cell particles the defer mask parks.
    for label, bounds, cap, h in (("C=32", (-90.0, 90.0, -45.0, 45.0), 32, 9.0),
                                  ("odd gw", (-95.0, 95.0, -50.0, 50.0), 64, 9.5)):
        sp = GridSpec.from_bounds(bounds, h, cap, pack2=True)
        prm = make_params(bounds=bounds, gravity=300.0, smoothing_radius=h)
        require(sp.gw % 2 == 1, f"{label}: expected an odd grid width, got {sp.gw}")
        pl = demo_planes(torch, sp, 0.4, 0.3, seed=cap, device="cuda")
        fa = fused_inputs(density_pairs, pl[0], pl[1], pl[2] * 20, pl[3] * 20, sp, prm)
        k6d_err = max(k6d_err, check_density(f"K6 ({label})", density_pairs, fa[0], fa[1],
                                             prm, pair=True)[1])
        e, nd = check_fused(f"K6 ({label})", force_pairs_integrated, fa, prm, pair=True)
        require(nd > 0, f"K6 ({label}): no deferred slot")
        k6f_err = max(k6f_err, e)
        k6r_err = max(k6r_err, check_raw(f"K6 ({label})", force_pairs, fa, prm, pair=True))
    # Against the classic kernels on the same C=64 planes (the layouts differ
    # only in block shape): K2's and K3's bars.
    ca_ = density_planes(wx, wy, p2)
    require(all(close(x, y, 1e-5, 0.0, wx < 5e5) for x, y in zip((rho2, rhon2), ca_)),
            "K6 density differs from K2 at C=64 beyond rtol 1e-5")
    kf, cf = force_pairs_integrated(*fargs2, p2), force_planes_integrated(*fargs2, p2)
    live2 = qx < 5e5
    require(all(close(x, y, 1e-4, 1e-4 if i < 2 else 1e-2, live2)
                for i, (x, y) in enumerate(zip(kf, cf))),
            "K6 fused walk differs from K3 at C=64 beyond the K3 bars")
    require(all(torch.equal(x[~live2], y[~live2]) for x, y in zip(kf, cf)),
            "K6 and K3 park dead slots differently")
    vs_classic = max(max_abs(x, y, live2) for x, y in zip(kf, cf))
    # Times in turns on the same planes: K6, classic, classic, K6.
    bargs2 = fargs2[:7]
    pair_ms = {"K6 density": [], "K2 density (C=64)": [], "K6 force + tail": [],
               "K3 force + tail (C=64)": [], "K6 raw": [], "K3b raw (C=64)": []}
    for order in ((0, 1), (1, 0)):
        for i in order:
            if i == 0:
                pair_ms["K6 density"].append(cuda_ms(lambda: density_pairs(wx, wy, p2), 20))
                pair_ms["K6 force + tail"].append(
                    cuda_ms(lambda: force_pairs_integrated(*fargs2, p2), 20))
                pair_ms["K6 raw"].append(cuda_ms(lambda: force_pairs(*bargs2, p2), 20))
            else:
                pair_ms["K2 density (C=64)"].append(
                    cuda_ms(lambda: density_planes(wx, wy, p2), 20))
                pair_ms["K3 force + tail (C=64)"].append(
                    cuda_ms(lambda: force_planes_integrated(*fargs2, p2), 20))
                pair_ms["K3b raw (C=64)"].append(cuda_ms(lambda: force_planes(*bargs2, p2), 20))
    pairs2 = window_pairs(wx)
    sc2 = density_scalars(p2), force_scalars(p2)
    record("K6d", "K6 pair-packed density walk", "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", k6d_err,
           min(pair_ms["K6 density"]),
           cuda_ms(lambda: density_planes_plain(wx, wy, *sc2[0], pair=True), 2),
           nbytes(wx, wy, rho2, rhon2), pairs2 * OPS_DENSITY_PAIR)
    record("K6f", "K6 pair-packed force walk + tail",
           "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", max(k6f_err, k6f_err_d),
           min(pair_ms["K6 force + tail"]),
           cuda_ms(lambda: force_planes_integrated_plain(*fargs2, sc2[1], pair=True), 2),
           nbytes(*fargs2) + nbytes(*fargs2[:4]), window_pairs(fargs2[0]) * OPS_FORCE_PAIR)
    record("K6r", "K6 pair-packed force walk, raw sums",
           "rust_particle_system_tpu_torch/csrc/sph.cu",
           "rust_particle_system_tpu/ops/pallas/sph.py:137", k6r_err, min(pair_ms["K6 raw"]),
           cuda_ms(lambda: force_planes_plain(*bargs2, sc2[1], pair=True), 2),
           nbytes(*bargs2) + nbytes(*bargs2[:4]), window_pairs(bargs2[0]) * OPS_FORCE_PAIR)
    print(f"phase 2: K6 (1M pair-packed C=64, {pairs2} window pairs) density "
          f"{k6d_err:.2e}, fused {max(k6f_err, k6f_err_d):.2e} ({n_def2} forced "
          f"deferrals), raw {k6r_err:.2e}, also at C=32 and odd gw; vs K2/K3 at C=64 "
          f"{vs_classic:.2e}; ms in turns {json.dumps(pair_ms)} [{card}]")

    # K8: the N-body disc at n = 16,384 (BASELINE.json config 3) and 1000, and
    # 1000 particles of which 500 share one point.  Bar: the JAX test's rtol
    # 2e-4 / atol 2e-3 (tests/test_pallas_nbody.py:18) with the relative part
    # taken of sum_j |delta_ij w_ij|, the magnitude each f32 sum carries: at
    # 16k, terms of ~100 cancel to near 0 and their rounding is left over.
    nparams = make_nbody_params()
    nmodel = MODEL_FAMILIES["nbody"].create()

    def term_scale(pos):
        eps2 = float(np.float32(nparams.softening) ** 2)
        out = []
        for i0 in range(0, pos.shape[0], 1024):
            d = pos[None] - pos[i0: i0 + 1024, None]
            inv = torch.rsqrt((d * d).sum(-1) + eps2)
            w = nparams.g_const * inv ** 3 - nparams.repulsion * nparams.softening * inv ** 4
            out.append((d.abs() * w.abs()[..., None]).sum(1))
        return torch.cat(out)

    k8_err = 0.0
    for label, n in (("disc", N_NBODY), ("disc", 1000), ("coincident", 1000)):
        pos = nmodel.init(torch.Generator(device="cuda").manual_seed(n), n).pos
        if label == "coincident":
            pos[:500] = pos[0].clone()
        ka, pa = nbody_accel(pos, nparams), nbody_accel_plain(pos, nparams)
        require(bool(torch.isfinite(ka).all()), f"K8 ({label}, n={n}) not finite")
        require(bool(torch.all((ka - pa).abs() <= 2e-3 + 2e-4 * term_scale(pos))),
                f"K8 ({label}, n={n}) differs from its plain version beyond the bar")
        k8_err = max(k8_err, max_abs(ka, pa))
    pos16 = nmodel.init(torch.Generator(device="cuda").manual_seed(N_NBODY), N_NBODY).pos
    record("K8", "K8 all-pairs N-body", "rust_particle_system_tpu_torch/csrc/nbody.cu",
           "rust_particle_system_tpu/ops/pallas/nbody.py:28", k8_err,
           cuda_ms(lambda: nbody_accel(pos16, nparams), 20),
           cuda_ms(lambda: nbody_accel_plain(pos16, nparams), 3),
           2 * nbytes(pos16), N_NBODY * N_NBODY * OPS_NBODY_PAIR)
    print(f"phase 2: K8 within the bar at n={N_NBODY} and 1000 (coincident particles "
          f"finite), max abs err {k8_err:.2e}")

    # K11, the cell-binned splat, against its plain version at 1080p and
    # capacity 64, rtol/atol 1e-4 (K4's bar), overflow equal, on (a) a 1M
    # uniform state, (b) the 50k scene's state under the camera (5, -3, 1.5),
    # with the JAX camera test's particle size 2 (3 px sprites), (c) a crammed
    # cluster whose cells exceed 64 and (d) particles on the image's edges,
    # off screen and on 8-px cell boundaries.  Where nothing overflowed, also
    # against the scatter splat at 1e-4 (tests/test_pallas_splat.py:38).
    gk = torch.Generator(device="cuda").manual_seed(13)
    sim50 = Simulation(SPHFluid.create(n=50_000))
    sim50.update_params(gravity=400.0)
    sim50.run(65)
    st50 = sim50.particle_state()
    xb = torch.arange(0.0, 1921.0, 8.0, device="cuda") - 960.0  # px on cell edges
    yb = 540.0 - torch.arange(0.0, 1081.0, 24.0, device="cuda")  # py on cell edges
    edge_pos = torch.cat([
        torch.stack(torch.meshgrid(xb, yb, indexing="ij"), -1).reshape(-1, 2),
        torch.tensor([[-960.0, -540.0], [960.0, 540.0], [-960.0, 540.0], [960.0, -540.0],
                      [1e4, 0.0], [-2000.0, -900.0], [0.0, 700.0], [-962.5, 0.0],
                      [962.5, 10.0]], device="cuda")])
    k11_cases = {
        "1M uniform": (lo + torch.rand((N_1M, 2), generator=gk, device="cuda") * (hi - lo),
                       torch.rand((N_1M, 4), generator=gk, device="cuda"), 3.0, None),
        "50k scene, camera": (st50.pos, st50.color, 2.0, CAMERA),
        "crammed": (torch.randn((20_000, 2), generator=gk, device="cuda") * 6.0,
                    torch.rand((20_000, 4), generator=gk, device="cuda"), 3.0, None),
        "edges": (edge_pos, torch.rand((edge_pos.shape[0], 4), generator=gk, device="cuda"),
                  3.0, None)}
    k11_err, k11_over = 0.0, {}
    for label, (kp, kc, ksize, kcam) in k11_cases.items():
        ka, ova = splat_cells(kp, kc, ksize, BOUNDS, rs_main, return_overflow=True,
                              camera=kcam)
        pa, ovp = splat_cells_plain(kp, kc, ksize, BOUNDS, rs_main, return_overflow=True,
                                    camera=kcam)
        require(tuple(ka.shape) == (1080, 1920, 4) and bool(torch.isfinite(ka).all()),
                f"K11 ({label}): image shape or non-finite values")
        require(close(ka, pa, 1e-4, 1e-4) and int(ova) == int(ovp),
                f"K11 ({label}) differs from its plain version beyond rtol/atol 1e-4 "
                f"(overflow {int(ova)} vs {int(ovp)})")
        require(float(pa[..., :3].amax()) > 0.0, f"K11 ({label}): nothing drawn")
        k11_err = max(k11_err, max_abs(ka, pa))
        k11_over[label] = int(ova)
        if int(ova) == 0:
            sa = splat(kp, kc, ksize, BOUNDS, rs_main, camera=kcam)
            require(close(ka, sa, 1e-4, 1e-4),
                    f"K11 ({label}) differs from the scatter splat beyond rtol/atol 1e-4")
    require(k11_over["crammed"] > 0 and k11_over["edges"] == 0 and k11_over["1M uniform"] == 0,
            f"K11 overflow cases not as built: {k11_over}")
    print(f"phase 2: K11 within rtol/atol 1e-4 of its plain version at 1080p, capacity 64 "
          f"({k11_err:.2e}), overflow equal {k11_over}; and of the scatter splat where 0")

    # K14a and K14c, the fast mode's stages A and C (protos.mxu_fast_forces),
    # on its time-mode state: 1M uniform, capacity 64, the default bounds.
    # Both force passes as fast_forces runs them: pass 1 (1 channel, 1 pair)
    # gives rho and P~, pass 2 (4 channels, 7 pairs) runs on them.  Each call
    # against its plain version on the same inputs at max abs <= 1e-5 x
    # max|plain| (the sums over slots and over b run in another order than
    # torch.bmm's), twice: on the planes as the time and stages modes feed
    # them, and with the slots the init spilled out of their full cells
    # parked as the walks park deferred slots (walk_positions).  A spilled
    # slot lies outside its cell, where the Chebyshev basis does not hold
    # (|u| up to ~2.7, T_12 ~1e8): its terms swamp the scale of the first
    # run, so the second holds every other slot.  Library: one torch.bmm on
    # precomputed Chebyshev tiles, timed only: [4 nc, NB, C] (w T_a) x
    # [4 nc, C, NB] (T_b) for K14a; for K14c [nc, C, NB^2] (T_a T_b per
    # slot) x [nc, NB^2, 7] (L).
    fm_spec, fm_ps, fm_vx, fm_vy, fm_cs = FF.time_inputs("cuda")
    fmx, fmy = R.walk_positions(fm_ps.px, fm_ps.py, fm_spec)
    fm_live = fmx < 5e5
    fnc, fcap = fm_spec.num_cells, fm_spec.capacity
    _, fu, fv = K14.cell_uv(fmx, fmy, fm_spec, FF.H)
    require(bool(((fu.abs() <= 1.0) & (fv.abs() <= 1.0)).all()), "a walk slot outside its cell")
    fm_errs = {}

    def check_fm(label, got, want) -> float:
        scale = float(want.abs().max())
        err = max_abs(got, want)
        require(err <= 1e-5 * scale, f"{label} differs from its plain version: max abs "
                f"{err:.3e} > 1e-5 x {scale:.3e}")
        fm_errs[label] = err / scale
        return err

    def fm_passes(x, y, live, tag):
        """Both passes through K14a/K14c, each call held to its plain
        version: (pass 2's weights, moments, transfers, evaluations, K14a's
        and K14c's max abs error)."""
        one = torch.where(live, 1.0, 0.0)
        m1 = K14.moments(x, y, [one], fm_spec, FF.H)
        check_fm(f"K14a, 1 channel{tag}", m1, K14.moments_plain(x, y, [one], fm_spec, FF.H))
        l1 = FF.transfers(m1, [(0, 0)], fm_cs)
        (rho,) = K14.evaluate(x, y, l1, fm_spec, FF.H, 1)
        check_fm(f"K14c, 1 pair{tag}", rho, K14.evaluate_plain(x, y, l1, fm_spec, FF.H, 1)[0])
        rho = rho.clamp_min(1e-6)
        w = [one, torch.where(live, FF.K_PRESS * (rho - FF.RHO0) / (rho * rho), 0.0),
             fm_vx, fm_vy]
        m = K14.moments(x, y, w, fm_spec, FF.H)
        err_a = check_fm(f"K14a, 4 channels{tag}", m, K14.moments_plain(x, y, w, fm_spec, FF.H))
        lt = FF.transfers(m, FF.PAIRS_2, fm_cs)
        e = K14.evaluate(x, y, lt, fm_spec, FF.H, 7)
        err_c = max(check_fm(f"K14c, pair {p}{tag}", g, q) for p, (g, q) in enumerate(
            zip(e, K14.evaluate_plain(x, y, lt, fm_spec, FF.H, 7))))
        return w, m, lt, e, err_a, err_c

    fm_passes(fm_ps.px, fm_ps.py, fm_ps.live, " (as fed)")
    w4, m4, l7, e7, k14a_err, k14c_err = fm_passes(fmx, fmy, fm_live, "")
    nb = K14.check_deg(12)
    tu = torch.stack(K14.cheb_cols(fu, nb), 1)  # [nc, NB, C]
    tv = torch.stack(K14.cheb_cols(fv, nb), -1)  # [nc, C, NB]
    wt = torch.stack([torch.where(fm_live, w, 0.0).reshape(fnc, fcap) for w in w4], 1)
    lib_a = ((wt[:, :, None, :] * tu[:, None]).reshape(4 * fnc, nb, fcap),
             tv[:, None].expand(fnc, 4, fcap, nb).reshape(4 * fnc, fcap, nb))
    phi = (tu.transpose(1, 2)[..., None] * tv[:, :, None, :]).reshape(fnc, fcap, nb * nb)
    lt = (l7.reshape(fnc, 7, 16, 16)[:, :, :nb, :nb].reshape(fnc, 7, nb * nb)
          .transpose(1, 2).contiguous())
    lib_a_out = torch.bmm(*lib_a).reshape(fnc, 4, nb, nb)
    lib_c_out = torch.where(fm_live.reshape(fnc, fcap, 1), torch.bmm(phi, lt), 0.0)
    e7_all = torch.stack([e.reshape(fnc, fcap) for e in e7], -1)
    lib_dev = (max_abs(lib_a_out, m4.reshape(fnc, 4, 16, 16)[..., :nb, :nb])
               / float(lib_a_out.abs().max()),
               max_abs(lib_c_out, e7_all) / float(e7_all.abs().max()))
    nlive_fm = int(fm_live.sum())
    record("K14a", "K14a fast-mode moments (4 channels)",
           "rust_particle_system_tpu_torch/csrc/fast_forces.cu", "protos/mxu_fast_forces.py:182",
           k14a_err, cuda_ms(lambda: K14.moments(fmx, fmy, w4, fm_spec, FF.H), 20),
           cuda_ms(lambda: K14.moments_plain(fmx, fmy, w4, fm_spec, FF.H), 5),
           nbytes(fmx, fmy, *w4, m4), nlive_fm * (ops_cheb(nb) + 4 * (nb + 2 * nb * nb)),
           cuda_ms(lambda: torch.bmm(*lib_a), 20))
    record("K14c", "K14c fast-mode evaluation (7 pairs)",
           "rust_particle_system_tpu_torch/csrc/fast_forces.cu", "protos/mxu_fast_forces.py:264",
           k14c_err, cuda_ms(lambda: K14.evaluate(fmx, fmy, l7, fm_spec, FF.H, 7), 20),
           cuda_ms(lambda: K14.evaluate_plain(fmx, fmy, l7, fm_spec, FF.H, 7), 5),
           nbytes(fmx, fmy, *e7) + 4 * fnc * 7 * nb * nb,
           nlive_fm * (ops_cheb(nb) + 7 * 2 * (nb * nb + nb)), cuda_ms(lambda: torch.bmm(phi, lt), 20))
    print(f"phase 2: K14a/K14c on the 1M C=64 fast-mode state as fed and with its "
          f"{int(fm_ps.live.sum()) - nlive_fm} spilled slots parked ({nlive_fm} walk slots) "
          f"within 1e-5 x max|plain| (max abs / max|plain| {json.dumps(fm_errs)}); the "
          f"library bmm calls "
          f"{lib_dev[0]:.2e} / {lib_dev[1]:.2e} from the kernels")
    # K14d-f, the stage A and C contraction forms at C=128 on a synthetic
    # basis (protos.fastmode_c128), at its 8,768 cells, against their plain
    # versions at max abs <= 1e-5 x max|plain|.  Library: one torch.bmm on
    # the precomputed basis tiles, timed only.
    cw, cl = C128.inputs(C128.NCP, "cuda")
    p13 = K14dF.basis(cw, K14dF.B1)
    p176 = K14dF.basis(cw, K14dF.B2P)
    pw13, p13t = (p13 * cw[:, None, :]).contiguous(), p13.transpose(1, 2).contiguous()
    c128_lib = {"K14d": lambda: torch.bmm(pw13, p13t),
                "K14e": lambda: torch.bmm(p176, cw[:, :, None]),
                "K14f": lambda: torch.bmm(cl[:, None, :], p176)}
    c128_err = {}
    for key, name, line, fn, plain, kargs, moved, ops in (
            ("K14d", "K14d C=128 stage A, batched mini-dot", 91, K14dF.a_dot, K14dF.a_dot_plain,
             (cw,), 4 * C128.NCP * (128 + 169), C128.NCP * (3 * 13 * 128 + 2 * 169 * 128)),
            ("K14e", "K14e C=128 stage A, multiply-reduce", 119, K14dF.a_vpu, K14dF.a_vpu_plain,
             (cw,), 4 * C128.NCP * (128 + 176), C128.NCP * 4 * 176 * 128),
            ("K14f", "K14f C=128 stage C, multiply-reduce", 147, K14dF.c_vpu, K14dF.c_vpu_plain,
             (cw, cl), 4 * C128.NCP * (128 + 176 + 128), C128.NCP * 4 * 176 * 128)):
        got, want = fn(*kargs), plain(*kargs)
        scale = float(want.abs().max())
        c128_err[key] = max_abs(got, want)
        require(c128_err[key] <= 1e-5 * scale, f"{key} differs from its plain version: max "
                f"abs {c128_err[key]:.3e} > 1e-5 x {scale:.3e}")
        lib_out = c128_lib[key]().reshape(want.shape)
        require(max_abs(lib_out, want) <= 1e-5 * scale, f"{key}'s library call differs")
        record(key, name, "rust_particle_system_tpu_torch/csrc/fastmode_c128.cu",
               f"protos/fastmode_c128.py:{line}", c128_err[key],
               cuda_ms(lambda: fn(*kargs), 20), cuda_ms(lambda: plain(*kargs), 5), moved, ops,
               cuda_ms(c128_lib[key], 20))
    print(f"phase 2: K14d-f at {C128.NCP} cells x 128 slots within 1e-5 x max|plain| "
          f"(max abs {json.dumps(c128_err)}); the library bmm calls too")
    # The whole fast_forces at 30k: card (K14a, K14c) vs plain path (CPU).
    cspec, cps = FF.uniform_planes(30_000, FF.CHECK_BOUNDS, 64, "cuda", seed=3)
    gvel = np.random.default_rng(4)
    cvx, cvy = (torch.where(cps.live, torch.from_numpy(
        (30.0 * gvel.standard_normal(tuple(cps.px.shape))).astype(np.float32)).cuda(), 0.0)
        for _ in range(2))
    ccs = FF.build_transfers(FF.H)
    got_card = FF.fast_forces(cps.px, cps.py, cvx, cvy, cspec, FF.H, ccs.cuda())
    got_cpu = FF.fast_forces(cps.px.cpu(), cps.py.cpu(), cvx.cpu(), cvy.cpu(), cspec, FF.H, ccs)
    clive = cps.live.cpu()
    ff_err = {}
    for fname, g, q in zip(FF.NAMES, got_card, got_cpu):
        scale = float(q[clive].abs().max())
        ff_err[fname] = max_abs(g.cpu(), q, clive) / scale
        require(ff_err[fname] <= 1e-4, f"fast_forces {fname} on the card differs from the "
                f"plain path beyond 1e-4 of its scale ({ff_err[fname]:.2e})")
    print(f"phase 2: fast_forces at 30k, card vs plain path (CPU), max abs / scale "
          f"{json.dumps(ff_err)}")

    # K13a-e, the toolchain probes, against their plain versions (K13a/b on
    # the card, in float64 where they sum, at max abs <= 1e-5 x max|plain|;
    # K13c/d/e bit for bit against the CPU).  Library: torch.matmul in FP32
    # (K13a) and with allow_tf32 set (K13b), torch.mul (K13c), the broadcast
    # view's float() (K13d, one copy kernel; bit-equal to K13d); none for
    # K13e (two casts and a multiply: no single call).
    da, db = (torch.from_numpy(m).cuda() for m in smoke.dot_inputs())
    k13_err = {}
    for key, fn, plain in (("K13a", K13.dot_f32, K13.dot_f32_plain),
                           ("K13b", K13.dot_tf32, K13.dot_tf32_plain)):
        want = plain(da, db)
        k13_err[key] = max_abs(fn(da, db), want)
        require(k13_err[key] <= 1e-5 * float(want.abs().max()),
                f"{key} differs from its plain version by {k13_err[key]:.3e}")
    ov, oo, _ = smoke.onehot_inputs()
    tov, too = torch.from_numpy(ov).cuda(), torch.from_numpy(oo).cuda()
    require(torch.equal(K13.dot_f32(tov, too), K13.dot_f32_plain(tov, too)),
            "K13a's one-hot product differs from its plain version")
    onehot_ms = (cuda_ms(lambda: K13.dot_f32(tov, too), 20),
                 cuda_ms(lambda: K13.dot_f32_plain(tov, too), 5), cuda_ms(lambda: tov @ too, 20))
    xid = torch.from_numpy(smoke.ids_inputs())
    k13c = K13.copy_ids(xid.cuda()).cpu()
    xbf = smoke.bf16_inputs()
    k13d = K13.bf16_broadcast(xbf.cuda()).cpu()
    oa, ob = smoke.bf16_outer_inputs()
    k13e = K13.bf16_outer(oa.cuda(), ob.cuda()).cpu()
    require(torch.equal(k13c.view(torch.int32), K13.copy_ids_plain(xid).view(torch.int32))
            and torch.equal(k13d.view(torch.int32),
                            K13.bf16_broadcast_plain(xbf).view(torch.int32))
            and torch.equal(k13e.view(torch.int32), K13.bf16_outer_plain(oa, ob).view(torch.int32)),
            "K13c, K13d or K13e differs from its plain version")
    xid, xbf, oa, ob = xid.cuda(), xbf.cuda(), oa.cuda(), ob.cuda()

    def bf16_library():
        return xbf[0:1].expand(8, 128).float().view(4, 256)

    require(torch.equal(bf16_library().view(torch.int32),
                        K13.bf16_broadcast(xbf).view(torch.int32)),
            "K13d's library call differs from K13d")

    def tf32_matmul():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return da @ db
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    dot_ops = 2 * 128 ** 3
    record("K13a", "K13a probe: FP32 dot (128^3)",
           "rust_particle_system_tpu_torch/csrc/toolchain_probe.cu", "tools/tpu_smoke.py:71",
           k13_err["K13a"], cuda_ms(lambda: K13.dot_f32(da, db), 20),
           cuda_ms(lambda: K13.dot_f32_plain(da, db), 5), 3 * nbytes(da), dot_ops,
           cuda_ms(lambda: da @ db, 20))
    record("K13b", "K13b probe: TF32 mma.sync dot (128^3)",
           "rust_particle_system_tpu_torch/csrc/toolchain_probe.cu", "tools/tpu_smoke.py:71",
           k13_err["K13b"], cuda_ms(lambda: K13.dot_tf32(da, db), 20),
           cuda_ms(lambda: K13.dot_tf32_plain(da, db), 5), 3 * nbytes(da), dot_ops,
           cuda_ms(tf32_matmul, 20), ops_rate=TF32_OPS_S)
    record("K13c", "K13c probe: id copy x * 1.0",
           "rust_particle_system_tpu_torch/csrc/toolchain_probe.cu", "tools/tpu_smoke.py:138",
           0.0, cuda_ms(lambda: K13.copy_ids(xid), 20),
           cuda_ms(lambda: K13.copy_ids_plain(xid), 20), 2 * nbytes(xid), xid.numel(),
           cuda_ms(lambda: torch.mul(xid, 1.0), 20))
    record("K13d", "K13d probe: bf16 broadcast-reshape",
           "rust_particle_system_tpu_torch/csrc/toolchain_probe.cu", "protos/bf16_repro.py:31",
           0.0, cuda_ms(lambda: K13.bf16_broadcast(xbf), 20),
           cuda_ms(lambda: K13.bf16_broadcast_plain(xbf), 20), nbytes(xbf) + 2 * nbytes(xbf),
           0, cuda_ms(bf16_library, 20))
    record("K13e", "K13e probe: bf16 outer product",
           "rust_particle_system_tpu_torch/csrc/toolchain_probe.cu", "protos/bf16_repro.py:65",
           0.0, cuda_ms(lambda: K13.bf16_outer(oa, ob), 20),
           cuda_ms(lambda: K13.bf16_outer_plain(oa, ob), 20), nbytes(oa, ob) + 4 * k13e.numel(),
           k13e.numel())
    print(f"phase 2: K13a/K13b within 1e-5 x max|plain| of the plain FP32 dot and the TF32 "
          f"emulation (max abs {k13_err['K13a']:.2e} / {k13_err['K13b']:.2e}); K13a's one-hot "
          f"product ([8, 256] x [256, 128]: {onehot_ms[0]:.4f} ms, plain {onehot_ms[1]:.3f}, "
          f"torch.matmul {onehot_ms[2]:.4f}), K13c (ids and subnormals), K13d and K13e (bf16) "
          f"bit-equal [{card}]")

    # The whole step on a small input, in both layouts: kernels (card) vs
    # plain versions (CPU).
    sb = (-90.0, 90.0, -45.0, 45.0)
    sp = make_params(bounds=sb, gravity=400.0)
    g2 = torch.Generator(device="cpu").manual_seed(3)
    spos = torch.stack([torch.rand(3000, generator=g2) * 180 - 90,
                        (torch.randn(3000, generator=g2) * 11.25).clamp(-45, 45)], -1)
    for small in (GridSpec.from_bounds(sb, 9.0, 128),
                  GridSpec.from_bounds(sb, 9.0, 64, pack2=True)):
        sc = R.plane_state_from_particles(port.make_state(spos.cuda()), small)
        sh = R.plane_state_from_particles(port.make_state(spos), small)
        for i in range(9):
            sc, sh = R.plane_step(sc, sp, small), R.plane_step(sh, sp, small)
            if i == 5:  # one live frame
                gc, gh_ = sc.to_particle_state(), sh.to_particle_state()
                require(close(gc.pos.cpu(), gh_.pos, 1e-4, 1e-4)
                        and close(gc.vel.cpu(), gh_.vel, 1e-4, 1e-2),
                        f"one live frame (C={small.capacity}): card differs from the "
                        "plain path")
        gc, gh_ = sc.to_particle_state(), sh.to_particle_state()
        require(int(sc.lost) == 0 and int(sc.live.sum()) == 3000, "small run lost particles")
        require(bool(torch.equal(gc.ids.cpu(), gh_.ids)), "small run ids differ")
        require(max_abs(gc.pos.cpu(), gh_.pos) <= 5e-4
                and max_abs(gc.vel.cpu(), gh_.vel) <= 5e-3,
                f"4 live frames (C={small.capacity}): card differs from the plain path "
                "beyond 5e-4 / 5e-3")
        print(f"phase 2: whole step (C={small.capacity}, pack2={small.pack2}), card vs "
              f"plain (CPU): 1 live frame within 1e-4, 4 live frames pos "
              f"{max_abs(gc.pos.cpu(), gh_.pos):.2e} vel {max_abs(gc.vel.cpu(), gh_.vel):.2e}")

    # The other models' steps on a small input, 3 frames from one state: card
    # vs CPU.  Bars: the N-body step's JAX bars, pos rtol/atol 1e-4 and vel
    # rtol 1e-4 / atol 2e-3 (tests/test_pallas_nbody.py:36-37), for all three:
    # the flow and attractor steps differ only in the last ulp of cos, sqrt
    # and division between the CUDA and CPU libraries.
    for m, n in (("nbody", 1000), ("flow", 3000), ("attractor", 3000)):
        mc = MODEL_FAMILIES[m].create()
        prm = mc.default_params()
        s0 = MODEL_FAMILIES[m].create(device="cpu").init(
            torch.Generator().manual_seed(4), n)
        st_c, st_h = port.make_state(s0.pos.cuda()), port.make_state(s0.pos)
        for _ in range(3):
            st_c, st_h = mc.step(st_c, prm), mc.step(st_h, prm)
        require(close(st_c.pos.cpu(), st_h.pos, 1e-4, 1e-4)
                and close(st_c.vel.cpu(), st_h.vel, 1e-4, 2e-3) and st_c.frame == 3,
                f"{m}: 3 steps on the card differ from the CPU beyond the bars")
        print(f"phase 2: {m} x {n}, 3 steps, card vs CPU: pos "
              f"{max_abs(st_c.pos.cpu(), st_h.pos):.2e} vel "
              f"{max_abs(st_c.vel.cpu(), st_h.vel):.2e}")

    # The spec on the card: N_ORACLE uniform particles (320 x 180 domain,
    # ~5 a cell), random velocities, gravity 80.  grid_step and one live frame
    # of plane_step (K1, K2, K3; id order) against reference_step.
    ob = (-160.0, 160.0, -90.0, 90.0)
    op = make_params(bounds=ob, gravity=80.0, shader_delay=0)
    go = torch.Generator(device="cuda").manual_seed(14)
    olo = torch.tensor([ob[0], ob[2]], device="cuda")
    ohi = torch.tensor([ob[1], ob[3]], device="cuda")
    so = port.make_state(olo + torch.rand((N_ORACLE, 2), generator=go, device="cuda")
                         * (ohi - olo),
                         (torch.rand((N_ORACLE, 2), generator=go, device="cuda") * 2 - 1) * 20.0)
    ref_o = reference_step(so, op)
    gspec = GridSpec.from_bounds(ob, 9.0, 64)
    got_g = grid_step(so, op, gspec)
    require(int(grid_physics(so, op, gspec)[1]) == 0, "the spec check's grid overflowed")
    require(spec_close(got_g, ref_o) and got_g.frame == ref_o.frame == 1,
            "grid_step differs from reference_step on the card beyond the one-frame bars")
    pspec = GridSpec.from_bounds(ob, 9.0, 128)
    po = R.plane_step(R.plane_state_from_particles(so, pspec), op, pspec)
    got_p = po.to_particle_state(op)
    require(int(po.lost) == 0 and torch.equal(
        got_p.ids, torch.arange(N_ORACLE, dtype=torch.int32, device="cuda")),
        "the spec check's plane state lost particles")
    require(spec_close(got_p, ref_o),
            "plane_step (K1/K2/K3) differs from reference_step on the card beyond the "
            "one-frame bars")
    print(f"phase 2: the spec on the card, n={N_ORACLE}, one live frame against "
          f"reference_step: grid_step pos {max_abs(got_g.pos, ref_o.pos):.2e} vel "
          f"{max_abs(got_g.vel, ref_o.vel):.2e}; plane_step pos "
          f"{max_abs(got_p.pos, ref_o.pos):.2e} vel {max_abs(got_p.vel, ref_o.vel):.2e}")

    # ---------------- phase 3: the user entry points ----------------
    kernels = kernel_counters()
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

    # pack2: the pair-packed model through Simulation, then step_and_render.
    reset()
    mp = SPHFluid.create(n=200_000, capacity=64, pack2=True)
    simp = Simulation(mp)
    simp.update_params(gravity=300.0)
    for _ in range(3):
        simp.run(15)
        require(int(simp.state.lost) == 0 and int(simp.state.live.sum()) == 200_000,
                "the pair-packed model lost particles")
    statsp = simp.stats()
    sq = simp.state
    for _ in range(5):
        sq, imgp = mp.step_and_render(sq, simp.params)
    torch.cuda.synchronize()
    launches = read("pack2")
    require(all(launches[k] > 0 for k in ("K1", "K4", "K5", "K6d", "K6f"))
            and launches["K2"] == launches["K3"] == launches["K3b"] == 0,
            f"the pack2 path did not run K6 in place of K2/K3: {launches}")
    require(int(sq.lost) == 0 and int(sq.live.sum()) == 200_000
            and bool(torch.isfinite(imgp).all()), "pack2 step_and_render frames")
    print(f"phase 3: pack2 (C=64) 200k x 45 frames + 5 step_and_render ok (lost 0, live "
          f"200000, max occupancy {statsp['grid_max_occupancy']}); launches {launches}")

    # pack2_unfused: its frame with the unfused tail (K6's raw walk).
    reset()
    for _ in range(5):
        sq, imgp = R.plane_frame(sq, simp.params, mp.grid, mp.render_spec,
                                 bounds_static=mp.bounds, fuse_tail=False)
    torch.cuda.synchronize()
    launches = read("pack2_unfused")
    require(launches["K6r"] > 0 and launches["K6f"] == launches["K3b"] == 0,
            f"the unfused pack2 path did not run K6's raw walk alone: {launches}")
    require(int(sq.live.sum()) == 200_000, "unfused pack2 frames lost particles")
    print(f"phase 3: 5 pack2 plane_frame(fuse_tail=False) frames ok; launches {launches}")

    # step_v5: plane_step(variant=5) at 1M from the phase-2 state, each frame
    # bit-equal to variant 6's (computed first, outside the counted window).
    fields = ("px", "py", "vx", "vy", "idsf")
    ref6 = [ps]
    for _ in range(4):
        ref6.append(R.plane_step(ref6[-1], params, spec))
    reset()
    s5 = ps
    for i in range(4):
        s5 = R.plane_step(s5, params, spec, variant=5)
        require(all(torch.equal(getattr(s5, f), getattr(ref6[i + 1], f)) for f in fields)
                and s5.frame == ref6[i + 1].frame,
                f"plane_step(variant=5) frame {i + 1} differs from variant 6's")
    torch.cuda.synchronize()
    launches = read("step_v5")
    require(launches["K9"] == 8 and launches["K1"] == launches["K7"] == launches["K12"] == 0
            and launches["K2"] == launches["K3"] == 4,
            f"the variant-5 path did not run K9 in place of K1: {launches}")
    require(int(s5.lost) == 0 and int(s5.live.sum()) == N_1M, "variant 5 lost particles")
    reset()
    f5, img5 = R.plane_frame(ps, params, spec, rs_main, bounds_static=BOUNDS, variant=5)
    torch.cuda.synchronize()
    launches = read("frame_v5")
    require(launches["K9"] == 2 and launches["K4"] == 1 and launches["K1"] == 0,
            f"plane_frame(variant=5) did not run K9 and K4: {launches}")
    f6, img6 = R.plane_frame(ps, params, spec, rs_main, bounds_static=BOUNDS)
    require(torch.equal(img5, img6) and all(torch.equal(getattr(f5, f), getattr(f6, f))
                                            for f in fields),
            "plane_frame(variant=5) differs from variant 6's")
    print(f"phase 3: plane_step(variant=5) at 1M, 4 frames bit-equal to variant 6; "
          f"plane_frame(variant=5) state and 1080p image bit-equal; launches "
          f"{paths['step_v5']}, {launches}")

    # step_v4, step_v3, step_v2: the 50k scene through the lossy variants.
    scene = Simulation(SPHFluid.create(n=50_000))
    scene.update_params(gravity=400.0)
    lossy = {}
    for v in (4, 3, 2):
        reset()
        st = scene.state
        for _ in range(65):  # 5 warm-up + 60 live frames
            st = R.plane_step(st, scene.params, scene.model.grid, variant=v)
        torch.cuda.synchronize()
        launches = read(f"step_v{v}")
        kern, other = ("K9", "K12") if v == 4 else ("K12", "K9")
        require(launches[kern] == (120 if v == 4 else 60) and launches[other] == 0
                and launches["K1"] == launches["K7"] == launches["K3"] == 0
                and launches["K3b"] == 60,
                f"plane_step(variant={v}) did not run {kern} and the raw walk alone: {launches}")
        live = st.live
        n_live, n_lost = int(live.sum()), int(st.lost)
        require(n_live + n_lost == 50_000, f"variant {v}: live {n_live} + lost {n_lost} != n")
        b = BOUNDS
        require(bool(torch.isfinite(st.vx[live]).all() and torch.isfinite(st.vy[live]).all())
                and bool((st.px[live] >= b[0]).all() and (st.px[live] <= b[1]).all()
                         and (st.py[live] >= b[2]).all() and (st.py[live] <= b[3]).all()),
                f"variant {v}: live particles not finite or out of bounds")
        lossy[v] = (st, n_lost)
    require(all(torch.equal(getattr(lossy[2][0], f), getattr(lossy[3][0], f)) for f in fields),
            "variant 2's planes differ from variant 3's")
    print(f"phase 3: the 50k scene, 60 live frames at variants 4/3/2: finite, in bounds, live + "
          f"lost == 50000 (lost {lossy[4][1]} / {lossy[3][1]} / {lossy[2][1]}); v2 planes "
          f"bit-equal to v3; launches {paths['step_v4']}, {paths['step_v3']}, {paths['step_v2']}")

    # nbody, flow, attractor: the CLI with --model, its PNG and --stats.
    model_runs = {"nbody": (N_NBODY, 30), "flow": (N_1M, 30), "attractor": (65_536, 30)}
    for m, (n, frames) in model_runs.items():
        png_m = HERE / "build" / f"chip_smoke_{m}.png"
        reset()
        rc = cli.main(["--model", m, "--n", str(n), "--frames", str(frames),
                       "--render", str(png_m), "--stats"])
        torch.cuda.synchronize()
        launches = read(m)
        require(rc == 0, f"cli --model {m} exited {rc}")
        require((launches["K8"] > 0) == (m == "nbody")
                and all(v == 0 for k, v in launches.items() if k != "K8"),
                f"cli --model {m}: unexpected launches {launches}")
        got = read_png(png_m)
        lit = int((got[..., :3].max(-1) > 0).sum())
        require(got.shape == (1080, 1920, 4) and lit > 1000,
                f"cli --model {m}: PNG {got.shape} with {lit} pixels lit")
        print(f"phase 3: cli --model {m} --n {n} --frames {frames} --render {png_m.name} "
              f"--stats ok ({lit} px lit); launches {launches}")

    def no_kernel(launches) -> bool:
        return all(v == 0 for v in launches.values())

    # grid: the sort-binned backend.  Its step launches no CUDA kernel; its
    # image is the scatter splat; splat_cells of its state (K11) at capacity
    # 64 reports its overflow, and at the densest cell's occupancy (nothing
    # left out) agrees with the image.
    reset()
    simg = Simulation(SPHFluid.create(n=50_000, backend="grid"))
    simg.update_params(gravity=400.0)
    yg0 = float(simg.state.pos[:, 1].mean())
    t0 = time.perf_counter()
    simg.run(5)
    statsg = []
    for _ in range((GRID_FRAMES - 5) // 60):
        simg.run(60)
        statsg.append(simg.stats())  # finite, in bounds, validate_grid, else raises
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    launches = read("grid_step")
    require(no_kernel(launches), f"the grid step launched a kernel: {launches}")
    stg = simg.state
    yg1 = float(stg.pos[:, 1].mean())
    require(stg.frame == GRID_FRAMES and yg1 < yg0 - 10.0,
            f"grid backend: frame {stg.frame}, y {yg0} -> {yg1}")
    gp, grs = simg.params, simg.model.render_spec
    imgg = simg.render()
    require(tuple(imgg.shape) == (1080, 1920, 4) and bool(torch.isfinite(imgg).all()),
            "grid backend image")
    _, over64 = splat_cells(stg.pos, stg.color, gp.particle_size, gp.bounds, grs,
                            return_overflow=True)
    occ, want64 = render_occupancy(torch, stg.pos, gp.bounds, grs)
    require(int(over64) == want64, f"K11 overflow {int(over64)} vs counted {want64}")
    kg, kover = splat_cells(stg.pos, stg.color, gp.particle_size, gp.bounds, grs,
                            capacity=max(64, occ), return_overflow=True)
    require(int(kover) == 0 and close(kg, imgg, 1e-4, 1e-4),
            "splat_cells of the grid state differs from its image beyond rtol/atol 1e-4")
    launches = read("grid")
    require(launches["K11"] == 2 and all(v == 0 for k, v in launches.items() if k != "K11"),
            f"the grid render path did not run K11 alone: {launches}")
    print(f"phase 3: grid backend 50k (capacity {simg.model.grid.capacity}) x {GRID_FRAMES} "
          f"frames ok, no kernel in the step; y {yg0:.1f} -> {yg1:.1f}; stats "
          f"{statsg[-1]}; {grid_s:.2f} s host clock incl. stats; K11 overflow at capacity "
          f"64: {int(over64)} (densest render cell {occ}); K11 at capacity {max(64, occ)} "
          f"within 1e-4 of the image ({max_abs(kg, imgg):.2e}); launches {launches} [{card}]")

    # cli_grid: the same run through the CLI, its PNG against grid's image.
    png_g = HERE / "build" / "chip_smoke_grid.png"
    reset()
    rc = cli.main(["--backend", "grid", "--n", "50000", "--frames", str(GRID_FRAMES),
                   "--set", "gravity=400", "--render", str(png_g), "--stats"])
    torch.cuda.synchronize()
    launches = read("cli_grid")
    require(rc == 0 and no_kernel(launches), f"cli --backend grid: rc {rc}, {launches}")
    got = read_png(png_g)
    diff = int(np.abs(got.astype(np.int64)
                      - to_srgb_u8(imgg).cpu().numpy().astype(np.int64)).max())
    require(got.shape == (1080, 1920, 4) and diff <= 1,
            f"cli --backend grid: PNG {got.shape}, {diff} LSB from the grid image")
    print(f"phase 3: cli --backend grid --render {png_g.name} --stats ok, max {diff} LSB "
          f"from grid's frame {GRID_FRAMES}; launches {launches}")

    # oracle: the all-pairs backend at N_ORACLE, 10 frames.
    reset()
    simo = Simulation(SPHFluid.create(n=N_ORACLE, backend="oracle"))
    simo.update_params(gravity=400.0)
    simo.run(10)
    statso = simo.stats()
    torch.cuda.synchronize()
    launches = read("oracle")
    require(no_kernel(launches) and simo.state.frame == 10 and simo.model.grid is None,
            f"oracle backend: {launches}")
    print(f"phase 3: oracle backend {N_ORACLE} x 10 frames ok ({statso}); launches {launches}")

    # flow_k11: the flow model at 1M, 10 frames, then one splat_cells (K11)
    # at the densest render cell's occupancy against model.render.
    reset()
    fm = MODEL_FAMILIES["flow"].create()
    simf = Simulation(fm, n=N_1M, seed=2)
    simf.run(10)
    fst, fp = simf.state, simf.params
    occf, overf64 = render_occupancy(torch, fst.pos, fp.bounds, fm.render_spec)
    kf, koverf = splat_cells(fst.pos, fst.color, fp.particle_size, fp.bounds, fm.render_spec,
                             capacity=max(64, occf), return_overflow=True)
    torch.cuda.synchronize()
    launches = read("flow_k11")
    require(launches["K11"] == 1 and all(v == 0 for k, v in launches.items() if k != "K11"),
            f"flow_k11: unexpected launches {launches}")
    wantf = fm.render(fst, fp)
    require(int(koverf) == 0 and close(kf, wantf, 1e-4, 1e-4),
            "splat_cells of the 1M flow state differs from model.render beyond 1e-4")
    print(f"phase 3: flow 1M x 10 frames, splat_cells at capacity {max(64, occf)} within "
          f"1e-4 of model.render ({max_abs(kf, wantf):.2e}); overflow at capacity 64 would "
          f"be {overf64}; launches {launches}")

    # fastmode: the fast mode's check through its entry point (30k, against
    # its exact oracle within its bars; it prints each output's error).  Its
    # state comes from the plane init (K5 once).
    reset()
    rc = FF.main(["check"])
    torch.cuda.synchronize()
    launches = read("fastmode")
    want_fm = {"K14a": 2, "K14c": 2, "K5": 1}
    require(rc == 0, f"mxu_fast_forces check exited {rc} (an output beyond its bar)")
    require(all(launches[k] == want_fm.get(k, 0) for k in launches),
            f"fastmode: unexpected launches {launches}")
    print(f"phase 3: mxu_fast_forces check (30k) within its bars; launches {launches}")

    # fastmode_c128: the C=128 contraction forms through their entry point
    # (4 timed calls of each after one warm call).
    reset()
    rc = C128.main(["4"])
    torch.cuda.synchronize()
    launches = read("fastmode_c128")
    want_c128 = {"K14d": 5, "K14e": 5, "K14f": 5}
    require(rc == 0, f"fastmode_c128 exited {rc}")
    require(all(launches[k] == want_c128.get(k, 0) for k in launches),
            f"fastmode_c128: unexpected launches {launches}")
    print(f"phase 3: fastmode_c128 timed its three forms; launches {launches}")

    # toolchain: every probe of the toolchain smoke test passes.
    reset()
    rc = smoke.main([])
    torch.cuda.synchronize()
    launches = read("toolchain")
    want_k13 = {"K13a": 2, "K13b": 2, "K13c": 1, "K13d": 1, "K13e": 1}
    require(rc == 0, f"toolchain_smoke exited {rc}")
    require(all(launches[k] == want_k13.get(k, 0) for k in launches),
            f"toolchain: unexpected launches {launches}")
    print(f"phase 3: toolchain_smoke all PASS; launches {launches}")

    mesh_ms = mesh_worlds(paths, card)

    for k in ("K1", "K2", "K3", "K4", "K5"):
        rows[k]["launches"] = paths["scene"][k]
    rows["K7"]["launches"] = paths["mesh_gloo"]["K7"]
    rows["K3b"]["launches"] = paths["unfused"]["K3b"]
    rows["K10"]["launches"] = paths["v1"]["K4"]
    rows["K6d"]["launches"] = paths["pack2"]["K6d"]
    rows["K6f"]["launches"] = paths["pack2"]["K6f"]
    rows["K6r"]["launches"] = paths["pack2_unfused"]["K6r"]
    rows["K8"]["launches"] = paths["nbody"]["K8"]
    rows["K9"]["launches"] = paths["step_v5"]["K9"]
    rows["K12"]["launches"] = paths["step_v3"]["K12"]

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

    # The JAX package's headline configuration (bench.py:387-389), pair-packed
    # against classic at the same C=64, in turns from the same state.
    st2 = uniform_plane_state(torch, spec2, N_1M, seed=8)
    for _ in range(5):
        st2 = R.plane_step(st2, p2, spec2)
    ms64 = {"pack2": [], "classic": []}
    for layout in ("pack2", "classic", "classic", "pack2"):
        sp_ = spec2 if layout == "pack2" else classic64
        held = [st2]

        def frame2(sp_=sp_, held=held):
            held[0] = R.plane_step(held[0], p2, sp_)

        ms64[layout].append(cuda_ms(frame2, 40))
        require(int(held[0].lost) == 0 and int(held[0].live.sum()) == N_1M,
                f"1M {layout} C=64 run lost particles")
    print(f"phase 4: 1M uniform C=64, gravity 300: pack2 step {ms64['pack2']} ms/frame, "
          f"classic {ms64['classic']} ms/frame (in turns) [{card}]")

    # The other models' frames: N-body at 16,384, flow at 1M, attractor at 64k.
    ms_models = {}
    for m, n in (("nbody", N_NBODY), ("flow", N_1M), ("attractor", 65_536)):
        simm = Simulation(MODEL_FAMILIES[m].create(), n=n, seed=1)
        simm.run(3)
        ms_models[m] = cuda_ms(lambda: simm.run(1), 50 if m == "nbody" else 200)
        require(bool(torch.isfinite(simm.state.pos).all()), f"{m} frames not finite")
    print(f"phase 4: ms/frame {json.dumps(ms_models)} (nbody n={N_NBODY}, flow n={N_1M}, "
          f"attractor n=65536) [{card}]")

    # K11 at 1080p, capacity 64: the kernel alone on the 1M flow state's
    # binning (its row), and splat_cells end to end beside the scatter splat
    # on the 1M flow state, the 50k scene (plane-resident) and the 50k grid
    # state; then the grid and oracle backends' frames.
    k11_args = raster_cells_inputs(fst.pos, fst.color, fp.particle_size, fp.bounds,
                                   fm.render_spec)
    ka, pa = raster_cells(*k11_args), raster_cells_plain(*k11_args)
    require(all(close(x, y, 1e-4, 1e-4) for x, y in zip(ka, pa)),
            "K11 accumulators differ from their plain version beyond rtol/atol 1e-4")
    k11_err = max([k11_err] + [max_abs(x, y) for x, y in zip(ka, pa)])
    kpx, kpy, _, kgrid, krs, kH, kW, kscal = k11_args
    k11_live = N_1M - int(kgrid.overflow)
    # The drawn slots (the first `capacity` of each cell in sort order) over
    # the pixel centres within the radius (edge start + edge width).
    kperm, kdrawn = kgrid.perm.long(), kgrid.slot < krs.capacity
    k11_pairs = sprite_pixels(kpx[kperm][kdrawn], kpy[kperm][kdrawn], kscal[0] + kscal[1],
                              kH, kW)
    record("K11", "K11 cell-binned splat", "rust_particle_system_tpu_torch/csrc/splat_cells.cu",
           "rust_particle_system_tpu/render/splat_pallas.py:45", k11_err,
           cuda_ms(lambda: raster_cells(*k11_args), 20),
           cuda_ms(lambda: raster_cells_plain(*k11_args), 3),
           nbytes(kpx, kpy) + 12 * N_1M + nbytes(kgrid.perm, kgrid.starts) + 4 * 4 * kH * kW,
           k11_pairs * ops_raster(4))
    splat_ms = {}
    for label, (sst, sprm, srs) in (("flow 1M", (fst, fp, fm.render_spec)),
                                    ("scene 50k", (sim.particle_state(), sim.params,
                                                   model.render_spec)),
                                    ("grid 50k", (stg, gp, grs))):
        args_s = (sst.pos, sst.color, sprm.particle_size, sprm.bounds, srs)
        splat_ms[label] = {"splat_cells (K11)": cuda_ms(lambda a=args_s: splat_cells(*a), 20),
                           "splat_cells, device (profiler)":
                               device_ms(lambda a=args_s: splat_cells(*a), 10),
                           "splat (scatter)": cuda_ms(lambda a=args_s: splat(*a), 5)}
    step_ms_backends = {"grid 50k": cuda_ms(lambda: simg.run(1), 20),
                        "grid 50k, device (profiler)": device_ms(lambda: simg.run(1), 5),
                        f"oracle {N_ORACLE}": cuda_ms(lambda: simo.run(1), 20),
                        f"oracle {N_ORACLE}, device (profiler)": device_ms(lambda: simo.run(1), 5)}
    require(bool(torch.isfinite(simg.state.pos).all() and torch.isfinite(simo.state.pos).all()),
            "grid or oracle frames not finite")
    print(f"phase 4: 1080p image ms {json.dumps(splat_ms)}; K11 kernel alone on the 1M flow "
          f"state {rows['K11']['ms']:.3f} ms ({k11_live} slots drawn, {k11_pairs} "
          f"(slot, pixel) pairs within the radius); ms/frame "
          f"{json.dumps(step_ms_backends)} [{card}]")
    # The variant-5 rebin at 1M stage by stage: CUDA events over a host loop
    # (host-bound where the stage's launches outrun its device work), and
    # the device time of its kernels by the profiler; K1 and variant 4 beside.
    stages = {
        "K9 pass Y": lambda: hole_fill_pass(*passY),
        "merge Y": lambda: retention_merge(flats1, midY, accY, spec, spec.gw, True),
        "K9 pass X": lambda: hole_fill_pass(*passX),
        "merge X": lambda: retention_merge(mergedY, outX, accX, spec, 1, False),
        "rebin v5": lambda: rebin_planes(rin, spec, variant=5),
        "rebin v6 (K1)": lambda: rebin_planes(rin, spec),
        "rebin v4": lambda: rebin_planes(rin, spec, variant=4),
        "rebin v3 (K12)": lambda: rebin_planes(rin, spec, variant=3)}
    rebin_ms = {k: cuda_ms(fn, 20) for k, fn in stages.items()}
    rebin_dev = {k: device_ms(fn, 10) for k, fn in stages.items()}
    print(f"phase 4: rebin at 1M, ms (events) {json.dumps(rebin_ms)}; device ms (profiler) "
          f"{json.dumps(rebin_dev)} [{card}]")
    # plane_step at 1M per rebin variant, in turns from one state.
    st6 = uniform_plane_state(torch, spec, N_1M, seed=9)
    st6 = dataclasses.replace(st6, frame=p4.shader_delay)
    for _ in range(5):
        st6 = R.plane_step(st6, p4, spec)
    step_ms = {6: [], 5: [], 4: []}
    for v in (6, 5, 4, 4, 5, 6):
        held = [st6]

        def frame_v(v=v, held=held):
            held[0] = R.plane_step(held[0], p4, spec, variant=v)

        step_ms[v].append(cuda_ms(frame_v, 40))
        require(int(held[0].live.sum()) + int(held[0].lost) == N_1M, f"variant {v}: live + lost")
    print(f"phase 4: 1M uniform C=128 plane_step ms/frame by rebin variant (in turns) "
          f"{json.dumps(step_ms)} [{card}]")
    rows["K11"]["launches"] = paths["flow_k11"]["K11"]
    # The fast mode at 1M: its stages and time modes through its entry point,
    # in one call (one input set, one timing of the production walks).
    print(f"phase 4: mxu_fast_forces stages time [{card}]", flush=True)
    require(FF.main(["stages", "time"]) == 0, "mxu_fast_forces stages time failed")
    for k in ("K14a", "K14c"):
        rows[k]["launches"] = paths["fastmode"][k]
    for k in ("K13a", "K13b", "K13c", "K13d", "K13e"):
        rows[k]["launches"] = paths["toolchain"][k]
    for k in ("K14d", "K14e", "K14f"):
        rows[k]["launches"] = paths["fastmode_c128"][k]
    order = ("K5", "K1", "K7", "K9", "K12", "K2", "K3", "K3b", "K4", "K10", "K11", "K6d", "K6f",
             "K6r", "K8", "K13a", "K13b", "K13c", "K13d", "K13e", "K14a", "K14c", "K14d",
             "K14e", "K14f")
    for k in order:
        r = rows[k]
        lib = "" if r["library_ms"] is None else f", one PyTorch call {r['library_ms']:.4f} ms"
        print(f"phase 4: {r['name']}: {r['ms']:.4f} ms kernel vs {r['plain_ms']:.3f} ms "
              f"plain, bound {r['bound_ms']:.5f} ms ({r['bound_by']}){lib}; launches "
              f"{r['launches']} [{card}]")

    result = {"kernels": [rows[k] for k in order]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            **result, "card": card, "build_s": build_s, "ms_per_frame_50k": ms50,
            "ms_per_frame_1m": ms1m, "ms_render_1m": ms_render,
            "ms_step_and_render_1m": ms_fused, "scene_300_s": scene_s,
            "ms_per_frame_1m_c64": ms64, "ms_walks_c64": pair_ms,
            "ms_per_frame_models": ms_models, "ms_mesh": mesh_ms, "paths": paths,
            "ms_rebin_1m": rebin_ms, "device_ms_rebin_1m": rebin_dev,
            "ms_per_frame_1m_by_variant": step_ms, "ms_image_1080p": splat_ms,
            "ms_per_frame_backends": step_ms_backends, "grid_frames_s": grid_s,
            "k11_overflow_phase2": k11_over, "k14_err_over_scale": fm_errs,
            "k14dF_max_abs": c128_err},
            indent=1))
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
