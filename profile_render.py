#!/usr/bin/env python3
"""Time the plane render K4 (csrc/splat_planes.cu) on one NVIDIA GPU.

    python3 profile_render.py [--parts] [--out result.json]

Run from the root of a checkout, on a machine with a CUDA card and nvcc; it
imports nothing of JAX.  On the states ``profile_step.py`` renders (1M
uniform C=128 after 5 live frames; the 50k scene after 300 frames), it times:

  k4_ms      the K4 wrapper alone by CUDA events (median of 3 runs of 50
             calls), as ``plane_frame`` calls it (energy ramp, sum rule 1,
             drift clamped, 1080p);
  render_ms  ``render_plane_state`` by events: the whole render, K4 and any
             torch op around it;
  render_device_ms, render_launches
             its device ms and its kernel launches per call, by
             ``torch.profiler``.

It also runs in a checkout of an earlier commit, whose K4 took the
pixel-space planes of ``raster_inputs`` (the torch glue then ran before it):
copy this script there, so that two commits are timed by the same code.

``--parts`` also builds csrc/splat_planes.cu as it stands, and copies of it
with one part cut out, each with nvcc into its own library under
build/render_parts/ (all started together), holds the full copy to the port's
K4 bit for bit, and times each by the profiler (median of 3 runs of 50 calls)
on both states:

  full         the kernel as it is;
  stage_only   each round's staging and its block syncs, no tile work;
  cull_only    staging and the warps' culled lists, no walk;
  no_alpha     the walk's hit masks, no hit added.

The cut-down copies compute wrong images on purpose; only their time is
read.  Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import struct
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "rust_particle_system_tpu_torch" / "csrc"
OUT_DIR = HERE / "build" / "render_parts"


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"profile_render: csrc/splat_planes.cu no longer has {old!r} once")
    return src.replace(old, new)


def parts(src: str) -> dict:
    """The kernel's source and its cut-down copies, by name."""
    drain = """        unsigned long long hits = half[0] | static_cast<unsigned long long>(half[1]) << 32;
        while (hits) {"""
    return {
        "full": src,
        "stage_only": _cut(src, "    if (tile_in) {", "    if (tile_in && k.C < 0) {"),
        "cull_only": _cut(src, "for (int e0 = 0; e0 < n; e0 += 64) {",
                          "for (int e0 = 0; e0 < n && k.C < 0; e0 += 64) {"),
        "no_alpha": _cut(src, drain, "        acc[NACC - 1] += static_cast<float>(half[0] ^ "
                         "half[1]);\n        unsigned long long hits = 0;\n        while (hits) {"),
    }


def build(sources: dict, nvcc_flags) -> tuple:
    """One library per copy, all nvcc runs started together: the bound
    entries and ptxas's resource lines of the sum-rule ramp kernel, by name."""
    procs = {}
    for name, src in sources.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "splat_planes.cu").write_text(src)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        so = d / "lib.so"
        procs[name] = (subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-Xptxas", "-v", "-shared",
             str(d / "splat_planes.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, resources = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"profile_render: nvcc failed on {name}:\n{out}")
        lines = out.splitlines()
        at = [i for i, line in enumerate(lines) if "render_kernelILi3ELi0E" in line]
        resources[name] = " | ".join(line.split(":", 1)[-1].strip()
                                     for line in lines[at[0]:at[0] + 4]
                                     if "registers" in line or "spill" in line)
        lib = ctypes.PyDLL(str(so))
        lib.rps_splat_planes.argtypes = (ctypes.c_char_p, ctypes.c_int)
        lib.rps_splat_planes.restype = ctypes.c_int
        libs[name] = lib.rps_splat_planes
    return libs, resources


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", action="store_true",
                    help="also time copies of the kernel with parts cut out")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(HERE))
    from chip_smoke import BOUNDS, N_1M, gpu_line, uniform_plane_state
    from rust_particle_system_tpu_torch.core.params import make_params
    from rust_particle_system_tpu_torch.models.sph import SPHFluid
    from rust_particle_system_tpu_torch.ops.cuda import _lib
    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.ops.grid import GridSpec
    from rust_particle_system_tpu_torch.render import RenderSpec
    from rust_particle_system_tpu_torch.render import splat_planes as SP
    from rust_particle_system_tpu_torch.runtime.profiling import device_ms
    from rust_particle_system_tpu_torch.runtime.simulation import Simulation
    from rust_particle_system_tpu_torch.runtime.timing import cuda_ms
    from torch.profiler import ProfilerActivity, profile

    card = gpu_line()
    print(card)
    rs = RenderSpec()
    states = {}
    spec = GridSpec.from_bounds(BOUNDS, 9.0, 128)
    p1 = make_params(bounds=BOUNDS)
    st = dataclasses.replace(uniform_plane_state(torch, spec, N_1M, seed=7),
                             frame=p1.shader_delay)
    for _ in range(5):
        st = R.plane_step(st, p1, spec)
    states["1M uniform C=128"] = (st, p1, spec)
    sim = Simulation(SPHFluid.create(n=50_000))
    sim.update_params(gravity=400.0)
    sim.run(300)
    states["50k scene after frame 300"] = (sim.state, sim.params, sim.model.grid)

    def k4_call(ps, prm, sp):
        """The K4 wrapper as plane_frame calls it, on its inputs."""
        margin = SP.drifted_patch_margin(sp, rs, BOUNDS)
        if hasattr(SP, "render_geometry"):  # world planes in, image out
            geo = SP.render_geometry(BOUNDS, sp, rs, margin, prm.particle_size)
            return lambda: SP.raster_planes(ps.px, ps.py, ps.vx, ps.vy, geo, prm.max_energy,
                                            color_sum=1.0, clamp_drift=True)
        ins = SP.raster_inputs(ps.px, ps.py, ps.vx, ps.vy, ps.live, prm.particle_size,
                               prm.max_energy, bounds_static=BOUNDS, grid_spec=sp,
                               render_spec=rs, margin=margin, color_sum=1.0)
        return lambda: SP.raster_planes(*ins, True)

    def launches(fn) -> int:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        return sum(1 for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.is_user_annotation) / 10

    result = {"card": card}
    for label, (ps, prm, sp) in states.items():
        k4 = k4_call(ps, prm, sp)
        render = lambda: R.render_plane_state(ps, prm, sp, rs, bounds_static=BOUNDS)
        result[label] = {
            "k4_ms": statistics.median(cuda_ms(k4, 50) for _ in range(3)),
            "render_ms": statistics.median(cuda_ms(render, 50) for _ in range(3)),
            "render_device_ms": device_ms(render, 50),
            "render_launches": launches(render)}

    if args.parts:
        libs, resources = build(parts((CSRC / "splat_planes.cu").read_text()), _lib.NVCC_FLAGS)
        result["ptxas"] = resources
        record = struct.Struct(_lib.RECORDS["rps_splat_planes"] + "0P")
        for label, (ps, prm, sp) in states.items():
            geo = SP.render_geometry(BOUNDS, sp, rs, SP.drifted_patch_margin(sp, rs, BOUNDS),
                                     prm.particle_size)
            (H, W, sx, sy, m), scal, world = geo
            gh, gw, C = ps.px.shape
            out = torch.empty(H, W, 4, device="cuda")

            def launch(fn, out=out, ps=ps, prm=prm, gh=gh, gw=gw, C=C):
                code = fn(record.pack(
                    ps.px.data_ptr(), ps.py.data_ptr(), ps.vx.data_ptr(), ps.vy.data_ptr(),
                    0, 0, 0, out.data_ptr(), gh, gw, C, H, W, sx, sy, m, 3, 0, 1, 1, *scal,
                    *world, prm.max_energy, 1.0, *SP.BLACK,
                    torch.cuda.current_stream().cuda_stream), record.size)
                if code:
                    raise RuntimeError(f"rps_splat_planes: CUDA error {code}")
                return out

            want = SP.raster_planes(ps.px, ps.py, ps.vx, ps.vy, geo, prm.max_energy,
                                    color_sum=1.0, clamp_drift=True)
            if not torch.equal(launch(libs["full"]), want):
                raise SystemExit(f"profile_render: the full copy differs from K4 on {label}")
            result[label]["parts_device_ms"] = {
                name: statistics.median(device_ms(lambda fn=fn: launch(fn), 50)
                                        for _ in range(3))
                for name, fn in libs.items()}
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
