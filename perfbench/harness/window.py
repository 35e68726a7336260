"""The frame loop a traffic mix describes, the same on one card and on every
rank of the mesh.

A cycle is ``cycle_frames`` frames from the initial state; the window is a
whole number of cycles, about ``--seconds`` long, so every run does the same
work however many cycles it takes.  The host enqueues each frame as soon as
the previous call returns and never reads back inside the window; a CUDA
event after each frame gives the frame times, read once the window is over.
Before the window's first event a lead of untimed frames (``LEAD_S``) fills
the launch queue, so the window starts on a busy card.
One frame of the last cycle, drawn from the seed, is kept for the check: its
input and its output (references, no copies: a frame writes only new
tensors).
"""

from __future__ import annotations

import gc
import math
import os
import random
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

LEAD_S = 0.5  # seconds of frames enqueued ahead of the window's first event


class Clock:
    """CUDA events on the card; on the CPU (the harness's tests) the host
    clock stands in, so the loop runs there unchanged."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def events(self, n: int) -> list:
        if self.cuda:
            return [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        return [[0.0] for _ in range(n)]

    def record(self, ev):
        if self.cuda:
            ev.record()
        else:
            ev[0] = time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b[0] - a[0]) * 1e3


def check_frame(seed: int, cycle_frames: int) -> int:
    """The frame of the last cycle that the check reads, drawn from the seed."""
    return random.Random(int(seed)).randrange(cycle_frames)


class Loop:
    """Drive ``frame(state) -> (state, aux)`` from ``init`` as ``traffic``
    says."""

    def __init__(self, frame, init, traffic: dict, seed: int, device: torch.device,
                 agree=lambda v: v, tally=None):
        self.frame, self.init, self.traffic = frame, init, traffic
        self.K = int(traffic["cycle_frames"])
        self.j = check_frame(seed, self.K)
        self.clock = Clock(device)
        self.agree = agree  # the mesh's ranks settle on one count
        self.tally = tally  # (state, aux) -> a device tensor kept per timed frame
        self.kept = None
        self.tallies = []

    def warm_up(self) -> float:
        """Every shape the window uses, then the seconds a frame takes.  What
        set-up wrote to disk (a checkout's first run builds the port's kernel
        library; Python writes its bytecode) is written back here, before
        the window, not when the kernel's writeback timer fires inside it;
        and what set-up left in memory (the imports, the harness's own
        objects) is frozen out of Python's cyclic collector, whose
        collections in the window then walk only the objects made there."""
        s = self.init
        for _ in range(int(self.traffic["warmup_frames"])):
            s, _ = self.frame(s)
        self.clock.sync()
        os.sync()
        gc.collect()
        gc.freeze()
        n = min(self.K, int(self.traffic["calibrate_frames"]))
        t0 = time.perf_counter()
        s = self.init
        for _ in range(n):
            s, _ = self.frame(s)
        self.clock.sync()
        return (time.perf_counter() - t0) / n

    def cycle(self, last: bool, after=None, tally: bool = False):
        """One cycle from the initial state; ``after(k, state_in, state_out)``
        runs after each frame's enqueue."""
        s = self.init
        for k in range(self.K):
            s_in = s
            s, aux = self.frame(s)
            if after is not None:
                after(k, s_in, s)
            if tally:
                self.tallies.append(self.tally(s, aux))
            if last and k == self.j:
                self.kept = (s_in, s, aux)
        return s

    def window(self, seconds: float, frame_s: float) -> dict:
        """The timed window: its frames' times (ms) and its length."""
        cycles = max(1, round(seconds / (self.K * frame_s)))
        cycles = int(self.agree(cycles))
        evs = self.clock.events(cycles * self.K + 1)
        # the host's clock and this thread's CPU clock as each frame is enqueued
        host = [(0.0, 0.0)] * (cycles * self.K + 1)
        f = [0]

        def mark(k, s_in, s_out):
            f[0] += 1
            self.clock.record(evs[f[0]])
            host[f[0]] = (time.perf_counter(), time.thread_time())

        # a lead of frames, untimed, fills the launch queue first: the card is
        # busy when the window's first event comes, and a stall of the host in
        # the window's first frames finds queued work instead of an idle card
        lead = int(self.agree(min(self.K, math.ceil(LEAD_S / frame_s))))
        s = self.init
        for _ in range(lead):
            s, _ = self.frame(s)
        del s
        start_wall = time.time()
        self.clock.record(evs[0])
        host[0] = (time.perf_counter(), time.thread_time())
        for c in range(cycles):
            self.cycle(c == cycles - 1, mark, tally=True)
        self.clock.sync()
        times = [self.clock.ms(evs[i], evs[i + 1]) for i in range(len(evs) - 1)]
        return {"start_wall": start_wall, "frames": len(times), "cycles": cycles,
                "frame_ms": times, "window_ms": self.clock.ms(evs[0], evs[-1]),
                "host_ms": [1e3 * (b[0] - a[0]) for a, b in zip(host, host[1:])],
                "host_cpu_ms": [1e3 * (b[1] - a[1]) for a, b in zip(host, host[1:])]}

    def traced(self) -> dict:
        """One cycle under the profiler, then the host's enqueue of single
        frames on a drained stream, then the inputs of the frames the work
        counts sample.  Returns the profile and the host times."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.clock.cuda else [])
        evs = self.clock.events(2)
        self.clock.sync()
        with profile(activities=acts) as prof:
            self.clock.record(evs[0])
            s = self.init
            for k in range(self.K):
                s_in = s
                with record_function("bench.enqueue"):
                    s, aux = self.frame(s)
                self.tallies.append(self.tally(s, aux))
                if k == self.j:
                    self.kept = (s_in, s, aux)
            self.clock.record(evs[1])
            with record_function("bench.drain"):
                self.clock.sync()
        window_ms = self.clock.ms(evs[0], evs[1])
        host = []
        s = self.init
        for _ in range(int(self.traffic["enqueue_frames"])):
            self.clock.sync()
            t0 = time.perf_counter()
            s, _ = self.frame(s)
            host.append(time.perf_counter() - t0)
        self.clock.sync()
        step = max(1, self.K // int(self.traffic["work_samples"]))
        samples = []
        self.cycle(False, lambda k, s_in, s_out: samples.append(s_in) if k % step == 0 else None)
        self.clock.sync()
        return {"prof": prof, "frames": self.K, "window_ms": window_ms,
                "enqueue_ms": 1e3 * sum(host) / len(host), "samples": samples}
