#!/usr/bin/env python3
"""Break the port's frame down by kernel on one NVIDIA GPU.

    python3 profile_step.py [--frames 100] [--out breakdown.json]

Run from the root of a checkout, on a machine with a CUDA card and nvcc; it
imports nothing of JAX.  The configurations ``chip_smoke.py`` times:

  * 1M particles, uniform, C=128, after 5 live frames, as the step alone and
    as the rendered frame (``step_and_render``, the step plus the 1080p image
    through the plane rasterizer);
  * the 50k reference scene (gravity 400) after 300 frames, the same two ways,
    and its step through the lossy full-window rebin (``plane_step(variant=3)``,
    kernel K12), restarted from the frame-300 state every 60 frames;
  * 1M particles, uniform, pair-packed C=64 (the JAX package's headline
    configuration, bench.py:387-389), the step, restarted every 40 frames;
  * the N-body at 16,384, the flow field at 1M and the attractor at 65,536
    particles, a frame each through ``Simulation.run(1)``;
  * the band-sharded step and the sharded frame with its 1080p image, 1M
    uniform C=128 on the grid padded to the bands, in a world of 4 ranks on
    the one card over gloo (halos staged through the host) and of 1 rank
    over NCCL (``parallel.run_bands``): each rank's own timing, kernel rows
    and largest host operator rows, under "mesh ...", one entry per rank.

For each case it measures, over ``--frames`` frames each:

  event_ms    ms per frame between CUDA events (the method of
              ``chip_smoke.py``, which averages 40 frames at 1M and 100 at 50k);
  enqueue_ms  host ms to enqueue one frame on a drained stream, averaged;
  busy_ms     device time per frame summed over the kernel rows of
              ``torch.profiler`` (one stream, so kernels do not overlap);
  idle        1 - busy_ms / event_ms, the device's idle share;
  rows        [kernel name, ms per frame, launches per frame], largest first;
  event_ms_after_profiler  event_ms again, once the profiler has run.

The profiler adds host time to every launch, so both configurations are
timed first and only then profiled; event_ms_after_profiler shows whether the
profiler left the process slower.  Prints the card's name and power limit,
then one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def timing(torch, frame, frames: int) -> dict:
    """event_ms and enqueue_ms of ``frames`` calls of ``frame()``."""
    frame()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(frames):
        frame()
    e1.record()
    e1.synchronize()
    event_ms = e0.elapsed_time(e1) / frames

    host_s = 0.0
    for _ in range(frames):  # one frame at a time: a full launch queue would block
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        host_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    enqueue_ms = host_s * 1e3 / frames
    return {"frames": frames, "event_ms": event_ms, "enqueue_ms": enqueue_ms}


def kernel_rows(torch, frame, frames: int, host_rows: int = 0) -> dict:
    """busy_ms and the per-kernel rows of ``frames`` profiled calls; with
    ``host_rows``, also that many host operator rows [name, self host ms per
    frame (the profiler's own cost included), calls per frame], largest
    first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    host = [[ev.key, ev.self_cpu_time_total / 1e3 / frames, ev.count / frames]
            for ev in prof.key_averages()  # operator rows repeat their kernels' time
            if ev.device_type != torch.autograd.DeviceType.CUDA]
    dev = {}  # the spans' projections onto the device are no rows of work
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            us, n = dev.get(ev.name, (0.0, 0))
            dev[ev.name] = (us + ev.time_range.end - ev.time_range.start, n + 1)
    rows = [[name, us / 1e3 / frames, n / frames] for name, (us, n) in dev.items()]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    out = {"busy_ms": busy_ms, "rows": rows}
    if host_rows:
        out["host_rows"] = sorted(host, key=lambda r: -r[1])[:host_rows]
    return out


def band_breakdown(mesh, frames: int) -> dict:
    """One rank of a sharded world: timing and kernel rows of its sharded step
    and of its sharded frame with the 1080p image, on its band of the 1M
    uniform C=128 state (chip_smoke.band_state)."""
    import torch

    from chip_smoke import BOUNDS, N_1M, band_state
    from rust_particle_system_tpu_torch.parallel import (
        gather_plane_state, make_plane_sharded_frame, make_plane_sharded_step,
        shard_plane_state)
    from rust_particle_system_tpu_torch.render import RenderSpec

    spec, params, whole = band_state(N_1M, 128, False, mesh.size, 7, mesh.device)
    held = [shard_plane_state(whole, mesh)]
    step = make_plane_sharded_step(spec, mesh)
    image_frame = make_plane_sharded_frame(spec, mesh, RenderSpec(), BOUNDS)

    def step_only():
        held[0], _ = step(held[0], params)

    def with_image():
        held[0], _, _ = image_frame(held[0], params)

    cases = {"step": step_only, "frame with image": with_image}
    out = {"rank": mesh.rank, "rows": spec.gh // mesh.size, "transport": mesh.backend}
    for key, frame in cases.items():
        out[key] = timing(torch, frame, frames)
        out[key].update(kernel_rows(torch, frame, frames, host_rows=15))
        out[key]["idle"] = 1.0 - out[key]["busy_ms"] / out[key]["event_ms"]
    got = gather_plane_state(held[0], mesh)
    if int(got.lost) != 0 or int(got.live.sum()) != N_1M:
        raise RuntimeError("the sharded run lost particles")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(HERE))
    from chip_smoke import BOUNDS, N_1M, N_NBODY, gpu_line, uniform_plane_state
    from rust_particle_system_tpu_torch.core.params import make_params
    from rust_particle_system_tpu_torch.models import MODEL_FAMILIES
    from rust_particle_system_tpu_torch.models.sph import SPHFluid
    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.ops.grid import GridSpec
    from rust_particle_system_tpu_torch.parallel import run_bands
    from rust_particle_system_tpu_torch.render import RenderSpec
    from rust_particle_system_tpu_torch.runtime.simulation import Simulation

    card = gpu_line()
    print(card)
    out = {"card": card}

    spec = GridSpec.from_bounds(BOUNDS, 9.0, 128)
    p1m = make_params(bounds=BOUNDS)
    st = uniform_plane_state(torch, spec, N_1M, seed=7)
    holder = [dataclasses.replace(st, frame=p1m.shader_delay)]

    def frame_1m():
        holder[0] = R.plane_step(holder[0], p1m, spec)

    def render_frame_1m():
        holder[0], _ = R.plane_frame(holder[0], p1m, spec, RenderSpec(),
                                     bounds_static=BOUNDS)

    for _ in range(5):
        frame_1m()
    sim = Simulation(SPHFluid.create(n=50_000))
    sim.update_params(gravity=400.0)
    sim.run(300)

    def render_frame_50k():
        sim.state, _ = sim.model.step_and_render(sim.state, sim.params)

    start_v3 = sim.state
    held_v3 = [start_v3, 0]

    def frame_50k_v3():
        # Restart every 60 frames, as chip_smoke.py's step_v3 path runs 60
        # live frames: the lossy rebin drops what overflows a cell.
        if held_v3[1] % 60 == 0:
            held_v3[0] = start_v3
        held_v3[0] = R.plane_step(held_v3[0], sim.params, sim.model.grid, variant=3)
        held_v3[1] += 1

    spec2 = GridSpec.from_bounds(BOUNDS, 9.0, 64, pack2=True)
    p2 = make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
    start2 = uniform_plane_state(torch, spec2, N_1M, seed=8)
    for _ in range(5):
        start2 = R.plane_step(start2, p2, spec2)
    held2 = [start2, 0]

    def frame_pack2():
        # Restart from the 5-frame state every 40 frames, as chip_smoke.py
        # times it: under gravity 300 the uniform state falls and, over the
        # hundreds of frames profiled here, piles up at the floor, where the
        # rebin defers most particles out of the walks.
        if held2[1] % 40 == 0:
            held2[0] = start2
        held2[0] = R.plane_step(held2[0], p2, spec2)
        held2[1] += 1
    others = {m: Simulation(MODEL_FAMILIES[m].create(), n=n, seed=1)
              for m, n in (("nbody", N_NBODY), ("flow", N_1M), ("attractor", 65_536))}

    cases = {"1M uniform C=128": frame_1m,
             "1M uniform C=128, step_and_render": render_frame_1m,
             "50k scene after frame 300": lambda: sim.run(1),
             "50k scene, step_and_render": render_frame_50k,
             "50k scene, plane_step(variant=3)": frame_50k_v3,
             "1M uniform pack2 C=64, gravity 300": frame_pack2,
             **{f"{m} x {o.n}": (lambda o=o: o.run(1)) for m, o in others.items()}}
    for key, frame in cases.items():
        out[key] = timing(torch, frame, args.frames)
    for key, frame in cases.items():
        out[key].update(kernel_rows(torch, frame, args.frames))
        out[key]["idle"] = 1.0 - out[key]["busy_ms"] / out[key]["event_ms"]
    for key, frame in cases.items():
        out[key]["event_ms_after_profiler"] = timing(torch, frame, args.frames)["event_ms"]
    if int(holder[0].lost) != 0 or int(holder[0].live.sum()) != N_1M:
        raise RuntimeError("1M run lost particles")
    if int(sim.state.lost) != 0 or int(sim.state.live.sum()) != 50_000:
        raise RuntimeError("50k run lost particles")
    if int(held2[0].lost) != 0 or int(held2[0].live.sum()) != N_1M:
        raise RuntimeError("1M pack2 run lost particles")
    mesh_frames = max(5, args.frames // 5)
    for n_bands, backend in ((4, "gloo"), (1, "nccl")):
        out[f"mesh {backend}, {n_bands} band(s), 1M uniform C=128"] = run_bands(
            band_breakdown, n_bands, backend, "cuda", timeout=600.0, args=(mesh_frames,))

    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
