#!/usr/bin/env python3
"""Split the rebin kernel K1 (csrc/rebin.cu), or K12 (csrc/rebin_compact.cu),
into its parts on one NVIDIA GPU.

    python3 profile_rebin.py [--k12] [--out parts.json]

Run from the root of a checkout, on a machine with a CUDA card and nvcc; it
imports nothing of JAX.  It builds csrc/rebin.cu as it stands and copies of
it with one part cut out (each with nvcc into its own library under
build/rebin_parts/), and times each by torch.profiler on the states
``profile_step.py`` runs: 1M uniform C=128 after 5 live frames, the 50k scene
after 300, 1M uniform pair-packed C=64 after 5.  The parts:

  full         the kernel as it is; its planes and counts must equal the
               port's K1 (``rebin_planes``) bit for bit, or the script fails;
  full, predicted at load  the same library handed the state's raw planes
               and the predict (``rebin_tile<true>``, as the frame calls it);
               it too must equal the port's K1 on the predicted planes;
  tile_cols/2  half the tile's columns (the geometry's alternative);
  phase_y      phase Y alone (phase X not run);
  y_pass1      phase Y's first pass alone (the ranks and words of pass 2 not
               made);
  y_pass1_no_loads    that pass on constants in place of its eight loads;
  y_pass1_no_ballots  that pass with each ballot replaced by the lane's bit.

With ``--k12`` it splits K12, the full-window compaction of rebin variants 2
and 3, on the first two states instead (its parts under build/compact_parts/):

  full         the kernel as it is; must equal the port's K12
               (``rebin_compact``) bit for bit;
  staging      the staging alone (no ranking warp runs);
  staging_ranking  the staging and the ranks and counts, no value moved and
               no fill written.

The cut-down copies compute wrong planes on purpose; only their time is read.
Prints the card's name and power limit, then one JSON object: ptxas's
registers and spills per part, and per state, per part, the device ms per
call (median of 3 runs of 50 calls).
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


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"profile_rebin: the kernel's source no longer has {old!r} once")
    return src.replace(old, new)


def parts(src: str) -> dict:
    """The kernel's source and its cut-down copies, by name."""
    y = _cut(src, "if (c < g.gw) column_x<", "if (c < 0) column_x<")
    pass2 = "  __syncwarp();\n\n  // Pass 2: hole h"
    y1 = _cut(y, pass2, pass2.replace("\n\n", "\n  if (C > 0) return;\n"))
    no_loads = _cut(y1, "  Fetched next = fetch(lane);",
                    "  Fetched next{{xs[0] == nullptr ? 0.0f : 1.0f, kDead, 5.0f, 7.0f}, "
                    "{2.0f, 4.0f, 6.0f, 8.0f}};")
    no_loads = _cut(no_loads, "if (q + 1 < nchunk) next = fetch(s + 32);", "next.y[0] += 1.0f;")
    cols = src[src.index("constexpr int tile_cols(int C) { return "):]
    cols = cols[:cols.index(";")]
    num = cols.split("clamp_int(")[1].split(" / C")[0]
    return {
        "full": src,
        "tile_cols/2": _cut(src, f"clamp_int({num} / C", f"clamp_int({int(num) // 2} / C"),
        "phase_y": y,
        "y_pass1": y1,
        "y_pass1_no_loads": no_loads,
        # phase Y's ballots come first in the file, phase X's second
        "y_pass1_no_ballots": y1.replace("const unsigned b = __ballot_sync(0xffffffffu, p[f]);",
                                         "const unsigned b = p[f] ? 1u : 0u;", 1),
    }


def compact_parts(src: str) -> dict:
    """K12's source and its cut-down copies, by name."""
    ranking = "for (int t = warp; t < T; t += kCompactWarps) {"
    ranks = _cut(src, "if (cand && rank < C) {", "if (cand && rank < 0) {")
    return {
        "full": src,
        "staging": _cut(src, ranking, ranking.replace("t < T;", "t < 0;")),
        "staging_ranking": _cut(ranks, "if (s >= before) for_channels",
                                "if (s >= before + C) for_channels"),
    }


def build(sources: dict, nvcc_flags, out_dir: Path, file: str, entry: str) -> tuple:
    """One library per part, all nvcc runs started together: the bound
    entries and ptxas's resource lines, by part."""
    procs = {}
    for name, src in sources.items():
        d = out_dir / name.replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / file).write_text(src)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        so = d / "lib.so"
        procs[name] = (subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-Xptxas", "-v", "-shared",
             str(d / file), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, resources = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"profile_rebin: nvcc failed on {name}:\n{out}")
        resources[name] = " | ".join(line.split(":", 1)[-1].strip() for line in out.splitlines()
                                     if "registers" in line or "spill" in line)
        fn = getattr(ctypes.PyDLL(str(so)), entry)
        fn.argtypes = (ctypes.c_char_p, ctypes.c_int)
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs, resources


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k12", action="store_true",
                    help="split K12 (csrc/rebin_compact.cu) instead of K1")
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_rebin: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(HERE))
    from chip_smoke import BOUNDS, N_1M, gpu_line, uniform_plane_state
    from rust_particle_system_tpu_torch.core.params import make_params
    from rust_particle_system_tpu_torch.models.sph import SPHFluid
    from rust_particle_system_tpu_torch.ops.cuda import _lib
    from rust_particle_system_tpu_torch.ops.cuda import resident as R
    from rust_particle_system_tpu_torch.ops.cuda.rebin import rebin_compact, rebin_planes
    from rust_particle_system_tpu_torch.ops.grid import GridSpec
    from rust_particle_system_tpu_torch.runtime.profiling import device_ms
    from rust_particle_system_tpu_torch.runtime.simulation import Simulation

    card = gpu_line()
    print(card)
    if args.k12:
        file, entry, split, exact, port = ("rebin_compact.cu", "rps_rebin_compact",
                                           compact_parts, ("full",),
                                           rebin_compact)
    else:
        file, entry, split, exact, port = ("rebin.cu", "rps_rebin", parts,
                                           ("full", "tile_cols/2"), rebin_planes)
    out_dir = HERE / "build" / ("compact_parts" if args.k12 else "rebin_parts")
    libs, resources = build(split((CSRC / file).read_text()), _lib.NVCC_FLAGS, out_dir, file,
                            entry)
    record = struct.Struct(_lib.RECORDS[entry] + "0P")

    def launch(fn, planes, spec, predict=None):
        """One launch on ``planes``; K1 with ``predict`` = (dt, gdt) takes
        them as the raw state and predicts at load."""
        k, (rows, gw, C) = len(planes), planes[0].shape
        out = [torch.empty_like(planes[0]) for _ in range(k)]
        counts = torch.empty(rows * gw, dtype=torch.int32, device=planes[0].device)
        fills = tuple(1e6 if c < 2 else 0.0 for c in range(k))
        ins = _lib.pad8([p.data_ptr() for p in planes])
        outs = _lib.pad8([o.data_ptr() for o in out])
        geometry = (spec.x_min, spec.y_min, spec.cell_width, spec.cell_size)
        stream = torch.cuda.current_stream().cuda_stream
        if args.k12:
            fields = (*ins, *outs, counts.data_ptr(), *_lib.pad8(fills), k, spec.gh, gw, C,
                      *geometry, stream)
        else:  # no ghost rows, no walk planes
            fields = (*ins, *(0,) * 18, *outs, 0, 0, counts.data_ptr(), *_lib.pad8(fills), k,
                      spec.gh, gw, C, 0, rows, int(predict is not None), *geometry,
                      *(predict or (0.0, 0.0)), stream)
        code = fn(record.pack(*fields), record.size)
        if code:
            raise RuntimeError(f"{entry}: CUDA error {code}")
        return out, counts

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
    if not args.k12:  # K12 serves variants 2 and 3, which no pair-packed path takes
        spec2 = GridSpec.from_bounds(BOUNDS, 9.0, 64, pack2=True)
        p2 = make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
        st2 = uniform_plane_state(torch, spec2, N_1M, seed=8)
        for _ in range(5):
            st2 = R.plane_step(st2, p2, spec2)
        states["1M uniform pack2 C=64"] = (st2, p2, spec2)

    result = {"card": card, "ptxas": resources}
    for label, (ps, prm, sp) in states.items():
        planes, raw, predict = R.predict_planes(ps, prm), R.planes_of(ps), R.predict_args(prm)
        calls = {name: (fn, planes, None) for name, fn in libs.items()}
        if not args.k12:
            calls["full, predicted at load"] = (libs["full"], raw, predict)
        want, wc = port(planes, sp)
        for name in (*exact, *calls.keys() - libs.keys()):
            got, gc = launch(*calls[name][:2], sp, calls[name][2])
            if not (all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(gc, wc)):
                raise SystemExit(f"profile_rebin: {name} differs from the port's kernel on "
                                 f"{label}")
        result[label] = {name: statistics.median(
            device_ms(lambda: launch(fn, pl, sp, pr), 50) for _ in range(3))
            for name, (fn, pl, pr) in calls.items()}
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
