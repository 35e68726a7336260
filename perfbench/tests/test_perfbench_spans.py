"""The attribution of device rows to the program's spans, on hand-built
profiler events shaped as ``torch.profiler``'s: the innermost span wins, a
row under no span goes to None, the rows are those of a reading's ``ops``,
and the metrics that were there read the same with the spans in the
profile."""

from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from harness import spans, spec, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Events:
    """A profile: host calls and spans, and the device rows launched by CUDA
    runtime calls that share their correlation ids."""

    def __init__(self):
        self.events, self.next_id = [], 1

    def _event(self, name, device, start, end, annotation=False, id=None):
        e = types.SimpleNamespace(name=name, device_type=device,
                                  id=self.next_id if id is None else id,
                                  is_user_annotation=annotation,
                                  time_range=types.SimpleNamespace(start=start, end=end))
        self.next_id += 1
        self.events.append(e)
        return e

    def call(self, name, start, end):
        """A host call or range (an op, or a span where ``name`` is one)."""
        return self._event(name, CPU, start, end, annotation=name.startswith(("sph.", "bench.")))

    def launch(self, name, at, start, end, runtime="cudaLaunchKernel"):
        """A device row over [start, end], launched on the host at ``at`` by
        a runtime call (none with ``runtime=None``: its call is missing)."""
        row = self._event(name, CUDA, start, end)
        if runtime:
            self._event(runtime, CPU, at, at + 0.5, id=row.id)
        return row

    def project(self, span, start, end):
        """A span's projection onto the device (a user annotation)."""
        return self._event(span.name, CUDA, start, end, annotation=True)

    def prof(self):
        return types.SimpleNamespace(events=lambda: self.events)


def _frame(with_spans=True):
    """One frame: a bench span over sph.frame > (sph.predict > aten::where,
    sph.rebin > a port kernel, sph.count > aten::sum), a memset launched in
    the frame under no phase, one launched after the frame, and a row whose
    runtime call is missing."""
    ev = Events()
    ev.call("bench.enqueue", 0.0, 100.0)
    if with_spans:
        frame = ev.call("sph.frame", 1.0, 90.0)
        predict = ev.call("sph.predict", 2.0, 20.0)
        ev.call("sph.rebin", 21.0, 40.0)
        ev.call("sph.count", 41.0, 60.0)
    ev.call("aten::where", 3.0, 10.0)
    ev.call("aten::sum", 42.0, 50.0)
    ev.launch("elementwise_kernel", 4.0, 200.0, 230.0)
    ev.launch("rebin_tile", 22.0, 230.0, 330.0, runtime="cuLaunchKernel")
    ev.launch("reduce_kernel", 43.0, 330.0, 340.0)
    ev.launch("Memset (Device)", 70.0, 340.0, 342.0, runtime="cudaMemsetAsync")
    ev.launch("Memcpy DtoD", 95.0, 342.0, 343.0, runtime="cudaMemcpyAsync")
    ev.launch("orphan_kernel", 5.0, 343.0, 344.0, runtime=None)
    ev._event("bench.enqueue", CUDA, 200.0, 344.0)  # the bench span on the device
    if with_spans:
        ev.project(frame, 200.0, 342.0)
        ev.project(predict, 200.0, 230.0)
    return ev


def test_innermost_span_wins_and_no_span_is_none():
    got = spans.attribute(_frame().events)
    assert got == {"sph.predict": (30.0, 1), "sph.rebin": (100.0, 1),
                   "sph.count": (10.0, 1), "sph.frame": (2.0, 1), None: (2.0, 2)}


def test_without_spans_every_row_is_under_none():
    assert spans.attribute(_frame(with_spans=False).events) == {None: (144.0, 6)}


def test_rows_are_the_readings_ops():
    """The spans' rows are exactly a reading's ``ops``: the device times sum
    to theirs, user annotations and bench rows left out of both."""
    ev = _frame()
    r = trace.read(ev.prof(), frames=1, window_ms=1.0, enqueue_ms=0.1)
    got = spans.attribute(ev.events)
    assert sum(n for _, n in got.values()) == len(r.ops)
    assert sum(us for us, _ in got.values()) == pytest.approx(sum(e - s for _, s, e in r.ops))


def test_metrics_read_the_same_with_and_without_program_spans():
    """A profile of the program with spans and without: the same ``ops``,
    so every metric that was there reads the same."""
    with_spans = trace.read(_frame().prof(), frames=1, window_ms=1.0, enqueue_ms=0.1)
    without = trace.read(_frame(with_spans=False).prof(), frames=1, window_ms=1.0,
                         enqueue_ms=0.1)
    assert with_spans.ops == without.ops
    assert with_spans.busy_s() == without.busy_s()
    for name in ("glue_ms", "launches_per_frame", "device_idle_share"):
        m = spec.metric(name)
        assert m.read([with_spans]) == m.read([without]), name


READERS = {"predict_ms": "sph.predict", "defer_ms": "sph.defer",
           "pressure_ms": "sph.pressure", "count_ms": "sph.count"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(metric):
    """Each reads its span's device ms a frame, the band with the most; None
    where no band has a row under it, or the reading holds no spans."""
    def reading(table, frames=4):
        r = trace.Reading(ops=[], frames=frames, window_s=0.01, enqueue_ms=0.1)
        r.spans = table
        return r

    name, m = READERS[metric], spec.metric(metric)
    bands = [reading({name: (2000.0, 8), None: (5.0, 1)}),
             reading({name: (3000.0, 8)}), reading({})]
    assert m.read(bands) == pytest.approx(0.75)  # 3000 us over 4 frames
    assert m.read([reading({"sph.other": (1.0, 1)})]) is None
    assert m.read([trace.Reading(ops=[], frames=4, window_s=0.01, enqueue_ms=0.1)]) is None


def test_torch_events_carry_what_the_attribution_reads():
    """The profiler's own events have the fields the hand-built ones stand
    in for; a span's range holds the host calls made inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("sph.predict"):
            torch.ones(8).sum()
    evs = prof.events()
    for e in evs:
        for field in ("name", "device_type", "id", "is_user_annotation", "time_range"):
            assert hasattr(e, field), field
    rng = next(e for e in evs if e.name == "sph.predict")
    total = next(e for e in evs if e.name == "aten::sum")
    assert rng.time_range.start <= total.time_range.start <= rng.time_range.end
    assert spans.attribute(evs) == {}  # no device rows on the CPU
