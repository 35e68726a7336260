"""Measurement helpers that wait for the device before they read a clock.

Counterpart of ``rust_particle_system_tpu/runtime/timing.py``.  PyTorch queues
CUDA work and returns before the card has run it, so a host clock read after
an unsynchronised call measures the enqueue.  Here ``hsync`` is a true
completion barrier: ``torch.cuda.synchronize()`` on the device of the CUDA
tensors it is given, nothing for CPU tensors (they are done when the call
returns).  ``time_fn`` keeps the JAX module's discipline of timing distinct
argsets, with one barrier per call, and reports the median.  ``cuda_ms``
times a run of calls between CUDA events on the current stream.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def _leaves(tree):
    """The tensors of a tree of lists, tuples, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def hsync(tree) -> None:
    """True completion barrier: synchronise every CUDA device that holds a
    tensor of ``tree``."""
    for dev in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def hsync_one(tree) -> None:
    """Synchronise the device of the FIRST tensor of ``tree`` (enough for a
    chained computation, whose tensors complete together)."""
    for t in _leaves(tree):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return


def time_chained(step, state, iters: int):
    """Time ``iters`` chained applications of ``step`` (each consumes the last
    output, so the chain self-serializes); ends with one barrier.  Returns
    (seconds_per_iter, final_state)."""
    hsync_one(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    hsync_one(state)
    return (time.perf_counter() - t0) / iters, state


def time_fn(fn, argsets, reps: int = 10, warm: int = 2):
    """Median per-call seconds of ``fn`` over distinct argsets, one barrier per
    call (unchained calls need a per-call barrier)."""
    for a in argsets[:warm]:
        hsync(fn(*a))
    times = []
    for r in range(reps):
        a = argsets[r % len(argsets)]
        t0 = time.perf_counter()
        hsync(fn(*a))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (after one warm call),
    between CUDA events on the current stream.  Needs a card."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps
