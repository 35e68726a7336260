"""One run of a cell on one device, or on one band of the mesh: set-up, the
window (or the traced cycle), then, once the peak memory is read, the check
against the reference and the work counts.

The pieces come by name from the cell's files (see :mod:`.spec`): the
configuration names its model (``models/<model>.py``: the program and its
judge) and its initial state (``inits/<init>.py``); the traffic mix names the
frame entry (``entries/<model>/<entry>.py``)."""

from __future__ import annotations

import torch

from . import spec, trace
from .window import Loop


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class Bands:
    """What the check of one band needs from the others: the ghost rows of
    the states it steps, and the other bands' parts of the numbers.  On one
    device the grid is one band and nothing moves."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def band(self, states: list, ghosts: tuple) -> tuple:
        """``(band, states)``: this band's ``(row0, lo, rows)`` (its own grid
        rows start at ``row0``; ``lo`` ghost rows lie below them) and each
        state's planes with the ``ghosts = (below, above)`` edge rows of the
        neighbour bands around them, all received in one exchange; none past
        the mesh's edges.  One device: the whole grid, the planes as they
        are."""
        rows = states[0][0].shape[0]
        m = self.mesh
        if m is None:
            return (0, 0, rows), states
        import torch.distributed as dist

        below, above = ghosts
        if rows < max(ghosts):
            raise ValueError(f"a band of {rows} rows: the check reads {below} rows below "
                             f"and {above} above across a seam, from the next band alone")
        planes = [p for s in states for p in s]
        ops, lo, hi = [], None, None

        def recv(n, peer):
            buf = torch.empty((len(planes), n) + planes[0].shape[1:], dtype=planes[0].dtype,
                              device=m.wire)
            ops.append(dist.P2POp(dist.irecv, buf, peer, m.group))
            return buf

        def send(part, peer):
            buf = torch.stack([part(p) for p in planes]).to(m.wire)
            ops.append(dist.P2POp(dist.isend, buf, peer, m.group))

        if m.rank + 1 < m.size:
            send(lambda p: p[rows - below:], m.rank + 1)
            hi = recv(above, m.rank + 1)
        if m.rank > 0:
            send(lambda p: p[:above], m.rank - 1)
            lo = recv(below, m.rank - 1)
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        edge = lambda buf, i: [] if buf is None else [buf[i].to(m.device)]
        ext = [torch.cat(edge(lo, i) + [p] + edge(hi, i)) for i, p in enumerate(planes)]
        k = len(states[0])
        return ((m.rank * rows, 0 if lo is None else below, rows),
                [ext[i: i + k] for i in range(0, len(ext), k)])

    def collect(self, part):
        """Every band's ``part``, in band order, on the first band; None on
        the others."""
        if self.mesh is None:
            return [part]
        import torch.distributed as dist

        parts = [None] * self.mesh.size
        dist.all_gather_object(parts, part, group=self.mesh.group)
        return parts if self.mesh.rank == 0 else None

    def agree(self, value: int) -> int:
        """The largest of the bands' values (every band runs as many frames)."""
        if self.mesh is None:
            return value
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64, device=self.mesh.wire)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return int(t.item())


def run(c: dict, seed: int, seconds: float, trace_on: bool, device, mesh=None,
        control: bool = False) -> dict:
    """One device's part of a run.  Returns its timings (or its trace
    reading) and, on the first band, the compared numbers (and, with
    ``control``, the control's), each band having checked its own rows."""
    device = torch.device(device)
    cfg, traffic, bench = c["config"], c["traffic"], c["bench"]
    model = spec.model(cfg["model"], bench)
    entry = spec.entry(cfg["model"], traffic["entry"], bench)
    make_particles = lambda: spec.init(cfg["init"], bench).particles(cfg, seed, device)
    bands = Bands(mesh)
    program = model.Program(cfg, device, mesh)
    init = program.init(make_particles())
    loop = Loop(entry.build(program), init, traffic, seed, device, bands.agree, program.tally)
    frame_s = loop.warm_up()
    out = {"rank": 0 if mesh is None else mesh.rank}
    if trace_on:
        tr = loop.traced()
        out["window"] = None
    else:
        out["window"] = loop.window(seconds, frame_s)
    out["memory_peak_bytes"] = _peak(device)
    tallies = torch.stack(loop.tallies).cpu()
    s_in, s_out, aux = loop.kept
    del loop
    out["attempted"] = int(tallies.shape[0])
    out["failed"], lost = program.failed(tallies)

    samples = []
    if trace_on:
        out["reading"] = trace.read(tr["prof"], tr["frames"], tr["window_ms"], tr["enqueue_ms"])
        samples = [program.planes(s) for s in tr.pop("samples")]
        del tr
    judge = model.Judge(cfg, bench, image=entry.IMAGE)
    band, states = bands.band([program.planes(s_in)] + samples, judge.GHOSTS)
    del samples, s_in
    planes_in, out_planes = states.pop(0), program.planes(s_out)
    image = aux if entry.IMAGE else None
    part = {"numbers": judge.numbers(make_particles(), program.planes(init), planes_in,
                                     out_planes, image, lost, band)}
    del init
    if trace_on:
        part["work"] = judge.census(states, out_planes, band)
        del states
    if control:
        part["control"] = judge.control(planes_in, band)
    parts = bands.collect(part)
    if parts is None:
        return out
    out["numbers"] = judge.combine([p["numbers"] for p in parts])
    if trace_on:
        out["reading"].work = judge.work([p["work"] for p in parts])
    if control:
        out["control_numbers"] = judge.combine([p["control"] for p in parts])
    return out
