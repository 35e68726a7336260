"""Which of the program's spans launched each device row of a traced cycle.

The port marks each phase of its frame with a ``torch.profiler`` range named
``sph.<phase>`` (``rust_particle_system_tpu_torch/runtime/profiling.py::
span``).  CUPTI gives every device row the correlation id of the CUDA call
that launched it on the host (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...;
the profiler's events carry it as ``id``, on the row and on the call).  The
row's span is the innermost ``sph.`` range around that call's start on the
host.  (torch 2.13's events also link each row to the op that launched it,
``linked_correlation_id``; torch 2.11's do not, so the host time of the
launching call is the link that both have.)  Rows whose call is missing, or
under no span of the program, go under ``None``.

The rows are those ``trace.read`` keeps in a reading's ``ops``: the CUDA
rows less the user annotations (every span's projection onto the device) and
the benchmark's own ``bench.`` rows; so the times here sum to its rows'
times, and a program without spans puts every row under ``None``.
"""

from __future__ import annotations

import bisect

import torch

PREFIX = "sph."
RUNTIME = "cu"  # the CUDA API calls that launch: cudaLaunchKernel, cuLaunchKernel, ...
_CPU = torch.autograd.DeviceType.CPU
_CUDA = torch.autograd.DeviceType.CUDA


def _device_row(e) -> bool:
    """A row of ``trace.read``'s ``ops``."""
    return e.device_type == _CUDA and not (getattr(e, "is_user_annotation", False)
                                           or e.name.startswith("bench."))


def _innermost(ranges, starts, t: float) -> str | None:
    """The innermost of the nested ``ranges`` (sorted by start, outer first)
    that holds host time ``t``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ranges[i][1] >= t:
            return ranges[i][2]
    return None


def rows_by_span(events):
    """``(span name or None, row)`` for each device row of a profile's
    ``events()``."""
    ranges, launched, rows = [], {}, []
    for e in events:
        if e.device_type == _CPU:
            if e.name.startswith(PREFIX):
                ranges.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name.startswith(RUNTIME):
                launched[e.id] = e.time_range.start
        elif _device_row(e):
            rows.append(e)
    ranges.sort(key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    for row in rows:
        t = launched.get(row.id)
        yield (None if t is None else _innermost(ranges, starts, t)), row


def attribute(events) -> dict:
    """``{span name or None: (device us, rows)}`` over the device rows of a
    profile's ``events()``."""
    out = {}
    for name, e in rows_by_span(events):
        us, rows = out.get(name, (0.0, 0))
        out[name] = (us + e.time_range.end - e.time_range.start, rows + 1)
    return out


def ms_per_frame(ranks, name: str) -> float | None:
    """Device ms a frame under span ``name``, the band with the most; None
    where no band's reading has a row under it (a reading without spans has
    none)."""
    ms = [r.spans[name][0] / 1e3 / r.frames for r in ranks
          if name in getattr(r, "spans", {})]
    return max(ms) if ms else None
