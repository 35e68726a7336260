#!/usr/bin/env python3
"""Split a benchmark cell's traced cycle by the port's spans, on one NVIDIA GPU.

    python3 profile_spans.py --workload sph16m_headless --seed 11 [--seed 12 ...] \\
        [--out spans.json]

Run from the root of a checkout, on a machine with a CUDA card and nvcc; it
imports nothing of JAX.  For each seed it runs the cell's traced cycle as
``perfbench/run.py --trace 1`` does (the same harness, the same reading) and
attributes every device row to the innermost ``sph.`` span of the frame that
launched it (``perfbench/harness/spans.py``).  The benchmark's reading does
not carry the spans (PERF.md §7), so this tool adds them to it.  Per seed:

  line        the result line's metrics (``glue_ms``, ``launches_per_frame``,
              the rooflines, ``host_enqueue_ms``, ...) and ``correct``;
  spans       per span (``null``: rows under no span of the program): device
              ms a frame, launches a frame, and the ms a frame of rows that
              are none of the port's kernels (what ``glue_ms`` counts);
  glue        ``predict_ms``, ``defer_ms``, ``pressure_ms``, ``count_ms``
              (the readers ``perfbench/metrics/<name>.py``), their sum with
              the other spans' torch rows, and ``glue_ms`` beside it;
  no_span     the share of the cycle's device busy time under no span;
  traced_frame_ms  the traced window over its frames (the profiler on).

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT)]

    from harness import result, spans, spec, trace

    glue = spec.metric("glue_ms", ROOT / "perfbench")
    port = [re.compile(p) for p in glue.PORT_KERNELS]
    readings, read = [], trace.read

    def read_with_spans(prof, frames, window_ms, enqueue_ms, *rest, **kw):
        r = read(prof, frames, window_ms, enqueue_ms, *rest, **kw)
        events = prof.events()
        r.spans = spans.attribute(events)
        r.table = _span_table(events, frames, port)
        readings.append(r)
        return r

    trace.read = read_with_spans
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    out = {"workload": args.workload, "card": card.stdout.strip(), "runs": []}
    for seed in args.seed:
        readings.clear()
        line = result.measure(args.workload, seed, 1.0, True, "cuda", ROOT)
        r = readings[0]
        metrics = {k: v["value"] for k, v in line["metrics"].items()}
        four = {m: spec.metric(m, ROOT / "perfbench").read([r]) for m in GLUE}
        other = sum(v["torch_ms"] for k, v in r.table.items()
                    if k not in ("sph.predict", "sph.defer", "sph.pressure", "sph.count"))
        busy_ms = 1e3 * r.busy_s() / r.frames
        run = {"seed": seed, "correct": line["correct"], "line": metrics,
               "spans": r.table,
               "glue": dict(four, other_torch_ms=other,
                            sum=sum(v or 0.0 for v in four.values()) + other,
                            glue_ms=metrics.get("glue_ms")),
               "no_span": (r.table.get("null", {}).get("ms", 0.0) / busy_ms
                           if busy_ms else None),
               "traced_frame_ms": 1e3 * r.window_s / r.frames,
               "idle_gaps": line["breakdown"]["idle_gaps"]}
        out["runs"].append(run)
        print(json.dumps({k: run[k] for k in ("seed", "correct", "glue", "no_span",
                                              "traced_frame_ms")}), flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
