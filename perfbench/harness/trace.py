"""What a traced cycle says: the device operations (torch.profiler's CUDA
rows), the device's busy time over the window, and the longest idle gaps by
what the host was doing.  One :class:`Reading` per device; the per-layer
metrics read them."""

from __future__ import annotations

import dataclasses
import re

import torch


@dataclasses.dataclass
class Reading:
    """One device's traced cycle.  ``ops``: (name, start_us, end_us) of every
    device operation; ``frames`` and ``window_s`` of the cycle;
    ``enqueue_ms``: the host's time to enqueue one frame on a drained
    stream; ``work``: the counts of the physics' own work per frame (on the
    mesh, of the whole grid, summed over the bands, on the first rank only)."""

    ops: list
    frames: int
    window_s: float
    enqueue_ms: float
    work: dict | None = None
    gaps: list = dataclasses.field(default_factory=list)

    def matching(self, patterns) -> list:
        rx = [re.compile(p) for p in patterns]
        return [o for o in self.ops if any(r.search(o[0]) for r in rx)]

    def ms_per_frame(self, patterns, exclude=()) -> float | None:
        """Device ms a frame of the rows matching any of ``patterns`` and
        none of ``exclude``; None when no row matches."""
        rows = self.matching(patterns)
        if exclude:
            ex = {id(o) for o in self.matching(exclude)}
            rows = [o for o in rows if id(o) not in ex]
        if not rows:
            return None
        return sum(e - s for _, s, e in rows) / 1e3 / self.frames

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of rows)."""
        busy, end = 0.0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e6


def _host_label(cpu, t: float) -> str:
    """The benchmark's own span and the innermost host call around ``t``."""
    around = [c for c in cpu if c[1] <= t <= c[2]]
    if not around:
        return "host.idle"
    spans = [c for c in around if c[0].startswith("bench.")]
    inner = min(around, key=lambda c: c[2] - c[1])[0]
    head = spans[0][0] if spans else "host"
    return head if inner == head else f"{head}:{inner}"


def read(prof, frames: int, window_ms: float, enqueue_ms: float, n_gaps: int = 10) -> Reading:
    """A :class:`Reading` of a profiled cycle."""
    dev, cpu = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            cpu.append(row)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            dev.append(row)  # the benchmark's spans are projected onto the device too
    dev.sort(key=lambda o: o[1])
    gaps, end = [], None
    for _, s, e in dev:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    labelled = [[_host_label(cpu, 0.5 * (a + b)), g / 1e6] for g, a, b in gaps[:n_gaps]]
    return Reading(ops=dev, frames=frames, window_s=window_ms / 1e3, enqueue_ms=enqueue_ms,
                   gaps=labelled)


def device_ops(readings, n: int = 10) -> list:
    """The device operations that took the most time, seconds summed over the
    devices' traced cycles."""
    tot = {}
    for r in readings:
        for name, s, e in r.ops:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[k[:64], v] for k, v in sorted(tot.items(), key=lambda t: -t[1])[:n]]


def idle_gaps(readings, n: int = 10) -> list:
    gaps = [g for r in readings for g in r.gaps]
    return sorted(gaps, key=lambda g: -g[1])[:n]
