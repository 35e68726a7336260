"""A whole run of a cell and its result line: the end-to-end metrics from the
window (``--trace 0``) or the per-layer ones from the traced cycle
(``--trace 1``), the device, and every compared number beside its limit."""

from __future__ import annotations

import math
import os
import time

from . import cell, check, mesh, spec, trace


def process_start() -> float:
    """This process's start on the wall clock (Linux: from /proc); the
    harness's import time where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def end_to_end(ranks: list, started: float) -> dict:
    """frame_ms: the slowest band's window over its frames; frame_p95_ms:
    the 95th percentile of each frame's slowest band; setup_s: process start
    to the last band's first timed frame."""
    wins = [r["window"] for r in ranks]
    per_frame = [max(ts) for ts in zip(*(w["frame_ms"] for w in wins))]
    slowest = lambda xs: sorted(range(len(xs)), key=lambda i: -xs[i])[:5]
    frames = ", ".join(f"#{i} {per_frame[i]:.3f} ms" for i in slowest(per_frame))
    stalled = max(wins, key=lambda w: max(w["host_ms"]))  # the band whose host stalled most
    host = ", ".join(f"#{i} {stalled['host_ms'][i]:.3f} ms "
                     f"({stalled['host_cpu_ms'][i]:.3f} on the CPU)"
                     for i in slowest(stalled["host_ms"]))
    return {"frame_ms": max(w["window_ms"] / w["frames"] for w in wins),
            "frame_p95_ms": p95(per_frame),
            "setup_s": max(w["start_wall"] for w in wins) - started,
            "_window": f"{len(per_frame)} frames in {wins[0]['cycles']} cycles; longest "
                       f"{frames}; host's longest enqueues {host}"}


def measure(workload: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
            root=spec.ROOT, control: bool = False, backend=None,
            started: float | None = None) -> dict:
    """Run ``workload`` and return its result line (a dict, keys in order)."""
    started = process_start() if started is None else started
    c = spec.cell(workload, root)
    if c["config"].get("bands", 1) > 1:
        ranks = mesh.run(c, seed, seconds, trace_on, device, backend, control)
    else:
        ranks = [cell.run(c, seed, seconds, trace_on, device, None, control)]
        ranks[0]["forbidden"] = []
    first = ranks[0]
    notes = []
    correct, shown = check.verdict(first["numbers"], c["limits"])
    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    if trace_on:
        readings = [r["reading"] for r in ranks]
        values = {m["name"]: spec.metric(m["name"], c["bench"]).read(readings)
                  for m in c["per_layer"]}
    else:
        e2e = end_to_end(ranks, started)
        values = {m["name"]: e2e[m["name"]] for m in c["end_to_end"]}
        notes.append("window: " + e2e["_window"])
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": _device_name(device), "count": len(ranks),
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    line = {"correct": correct, "attempted": first["attempted"], "failed": first["failed"],
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()
                        if v is not None},
            "device": dev}
    if trace_on:
        dev["busy_s"] = sum(r.busy_s() for r in readings) / len(readings)
        dev["window_s"] = sum(r.window_s for r in readings) / len(readings)
        line["breakdown"] = {"device_ops": trace.device_ops(readings),
                             "idle_gaps": trace.idle_gaps(readings)}
    if control:
        line["control_correct"], line["control_checks"] = check.verdict(
            first["control_numbers"], c["limits"])
    line["checks"] = shown
    line["_forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    line["_notes"] = notes
    return line


def _device_name(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return device
