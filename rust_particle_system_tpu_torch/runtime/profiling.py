"""Profiling helpers: a ``torch.profiler`` trace of any window, a phase timer
for host loops, and the card's kernel time of a call.

Counterpart of ``rust_particle_system_tpu/runtime/profiling.py`` (which wraps
``jax.profiler``).  ``trace`` writes a Chrome trace (``chrome://tracing`` or
Perfetto open it); its kernel rows are the device's own times.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write its
    Chrome trace to ``log_dir/trace.json`` when it ends.  Yields the
    profiler, whose ``key_averages()`` sums the rows by name."""
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_ms(fn, reps: int) -> float:
    """Milliseconds per call of the card's kernel time, by torch.profiler:
    the sum of the CUDA kernel rows over ``reps`` calls (after one warm
    call), so a host-bound call reads its device work, not its enqueue."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
    return us / 1e3 / reps


class PhaseTimer:
    """Wall-clock per-phase accumulator.  A phase ends with
    ``torch.cuda.synchronize()`` once the process uses a card, so a phase of
    device work is timed to its completion, not to its enqueue.

    >>> t = PhaseTimer()
    >>> with t.phase("step"): state = step(state, params)
    >>> with t.phase("render"): img = render(state)
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        stats = {
            name: {
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "mean_ms": round(total / self.counts[name] * 1e3, 3),
            }
            for name, total in sorted(self.totals.items())
        }
        for name, s in stats.items():
            print(f"{name:20s} {s['mean_ms']:10.3f} ms/call x{s['calls']}")
        return stats
