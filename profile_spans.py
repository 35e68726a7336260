#!/usr/bin/env python3
"""Split a benchmark cell's traced cycle by the port's spans, on NVIDIA GPUs.

    python3 profile_spans.py --workload sph16m_headless --seed 11 [--seed 12 ...] \\
        [--out spans.json]

Run from the root of a checkout, on a machine with the cell's CUDA cards and
nvcc; it imports nothing of JAX.  For each seed it runs the cell's traced
cycle as ``perfbench/run.py --trace 1`` does (the same harness, the same
reading; a band cell in one process a band, each tracing its own) and
attributes every device row to the innermost ``sph.`` span of the frame that
launched it (``perfbench/harness/spans.py``).  The benchmark's reading does
not carry the spans (PERF.md §7), so this tool adds them to it.  Per seed:

  line        every per-layer metric of the benchmark as its reader reads
              this run (``glue_ms``, ``launches_per_frame``, the rooflines,
              ``host_enqueue_ms``, ...; null where it finds nothing), and
              ``correct``;
  spans       per span (``null``: rows under no span of the program): device
              ms a frame, launches a frame, and the ms a frame of rows that
              are none of the port's kernels (what ``glue_ms`` counts); the
              first band's on a band cell;
  glue        ``predict_ms``, ``defer_ms``, ``pressure_ms``, ``count_ms``
              (the readers ``perfbench/metrics/<name>.py``), their sum with
              the other spans' torch rows, and ``glue_ms`` beside it;
  bands       on a band cell, per band: ``sph.halo`` and ``sph.reduce`` ms a
              frame and the bytes it received a frame by direction (the
              mesh's counter, ``BandMesh.received``, over one frame);
  no_span     the share of the cycle's device busy time under no span;
  traced_frame_ms  the traced window over its frames (the profiler on);
  deferred    per band (one on one card): the slots the defer mask parked
              in the last frame the program stepped, as a count and as a
              share of the live slots, read from the walk x plane against
              the rebinned x plane after the run (the frame keeps references
              to the two planes; nothing is counted inside the frames).

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT)]
GLUE = ("predict_ms", "defer_ms", "pressure_ms", "count_ms")


def _span_table(events, frames: int, port) -> dict:
    """Per span: device ms a frame, launches a frame, torch rows' ms a frame."""
    from harness import spans

    rows = {}
    for name, e in spans.rows_by_span(events):
        us = e.time_range.end - e.time_range.start
        t = rows.setdefault(name or "null", [0.0, 0, 0.0])
        t[0] += us
        t[1] += 0 if re.search(r"^Memcpy|^Memset", e.name) else 1
        t[2] += 0.0 if any(p.search(e.name) for p in port) else us
    return {k: {"ms": v[0] / 1e3 / frames, "launches": v[1] / frames,
                "torch_ms": v[2] / 1e3 / frames} for k, v in sorted(rows.items())}


def _deferred(last: dict) -> dict | None:
    """The slots the defer mask parked in the kept frame: live in the
    rebinned x plane, parked in the walk x plane."""
    from rust_particle_system_tpu_torch.ops.cuda.rebin import SENTINEL

    if not last:
        return None
    live = last["npx"] < 0.5 * SENTINEL
    slots = int((live & ~(last["fpx"] < 0.5 * SENTINEL)).sum())
    n = int(live.sum())
    return {"slots": slots, "live": n, "share": slots / n if n else None}


def _band(mesh, c: dict, seed: int, device: str = "cuda") -> dict:
    """One band's (or the one card's) traced run: its reading carries the
    spans, the span table, the bytes the band received in its last frame,
    by direction, and the deferred slots of its last frame."""
    import torch

    from harness import cell, spans, spec, trace, window
    from rust_particle_system_tpu_torch.ops.cuda import resident

    glue = spec.metric("glue_ms", c["bench"])
    port = [re.compile(p) for p in glue.PORT_KERNELS]
    read, loop_init = trace.read, window.Loop.__init__
    walk_and_integrate = resident.walk_and_integrate
    received, last = {}, {}

    def read_with_spans(prof, frames, *rest, **kw):
        r = read(prof, frames, *rest, **kw)
        events = prof.events()
        r.spans = spans.attribute(events)
        r.table = _span_table(events, frames, port)
        return r

    def counted_loop(self, frame, *rest, **kw):
        def counted(s):
            before = dict(mesh.received)
            out = frame(s)
            received.update({k: v - before.get(k, 0) for k, v in mesh.received.items()})
            return out

        loop_init(self, frame if mesh is None else counted, *rest, **kw)

    def kept_walk(rebinned, walk, *rest, **kw):
        last["npx"], last["fpx"] = rebinned[0], walk[0]
        return walk_and_integrate(rebinned, walk, *rest, **kw)

    trace.read, window.Loop.__init__ = read_with_spans, counted_loop
    resident.walk_and_integrate = kept_walk
    try:
        out = cell.run(c, seed, 1.0, True,
                       torch.device(device if mesh is None else mesh.device), mesh)
    finally:
        trace.read, window.Loop.__init__ = read, loop_init
        resident.walk_and_integrate = walk_and_integrate
    out["reading"].received = received
    out["reading"].deferred = _deferred(last)
    last.clear()
    return out


def _ranks(c: dict, seed: int, device: str = "cuda", backend: str | None = None) -> list:
    """Every band's :func:`_band`, in band order (one on one card)."""
    bands = int(c["config"].get("bands", 1))
    if bands == 1:
        return [_band(None, c, seed, device)]
    from rust_particle_system_tpu_torch.parallel import run_bands

    return run_bands(_band, bands, backend or c["traffic"]["backend"], device, 330.0,
                     args=(c, seed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from harness import check, spec, trace

    bench = ROOT / "perfbench"
    c = spec.cell(args.workload, ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    out = {"workload": args.workload, "card": card.stdout.strip(), "runs": []}
    for seed in args.seed:
        ranks = _ranks(c, seed)
        readings = [r["reading"] for r in ranks]
        r = readings[0]
        metrics = {m["name"]: spec.metric(m["name"], bench).read(readings)
                   for m in spec.benchmark(ROOT)["per_layer"]}
        correct, _ = check.verdict(ranks[0]["numbers"], c["limits"])
        four = {m: spec.metric(m, bench).read([r]) for m in GLUE}
        other = sum(v["torch_ms"] for k, v in r.table.items()
                    if k not in ("sph.predict", "sph.defer", "sph.pressure", "sph.count"))
        busy_ms = 1e3 * r.busy_s() / r.frames
        ms = lambda x, name: x.table.get(name, {}).get("ms")
        run = {"seed": seed, "correct": correct, "line": metrics,
               "spans": r.table,
               "glue": dict(four, other_torch_ms=other,
                            sum=sum(v or 0.0 for v in four.values()) + other,
                            glue_ms=metrics.get("glue_ms")),
               "no_span": (r.table.get("null", {}).get("ms", 0.0) / busy_ms
                           if busy_ms else None),
               "traced_frame_ms": 1e3 * r.window_s / r.frames,
               "idle_gaps": trace.idle_gaps(readings),
               "deferred": [x.deferred for x in readings]}
        if len(readings) > 1:
            run["bands"] = [{"sph.halo_ms": ms(x, "sph.halo"), "sph.reduce_ms": ms(x, "sph.reduce"),
                             "received_bytes": x.received} for x in readings]
        out["runs"].append(run)
        print(json.dumps({k: run.get(k) for k in ("seed", "correct", "glue", "bands", "no_span",
                                                  "traced_frame_ms", "deferred")}),
              flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
