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


class Gather:
    """Whole planes from every band's slab (the mesh), or the planes as they
    are (one device)."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def planes(self, slab: list) -> list:
        if self.mesh is None:
            return slab
        import torch.distributed as dist

        m = self.mesh
        out = []
        for p in slab:
            buf = p.to(m.wire).contiguous()
            parts = [torch.empty_like(buf) for _ in range(m.size)]
            dist.all_gather(parts, buf, group=m.group)
            out.append(torch.cat(parts).to(m.device) if m.rank == 0 else None)
            del parts
        return out if m.rank == 0 else None

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
    ``control``, the control's)."""
    device = torch.device(device)
    cfg, traffic, bench = c["config"], c["traffic"], c["bench"]
    model = spec.model(cfg["model"], bench)
    entry = spec.entry(cfg["model"], traffic["entry"], bench)
    make_particles = lambda: spec.init(cfg["init"], bench).particles(cfg, seed, device)
    gather = Gather(mesh)
    first = mesh is None or mesh.rank == 0
    program = model.Program(cfg, device, mesh)
    init = program.init(make_particles())
    loop = Loop(entry.build(program), init, traffic, seed, device, gather.agree, program.tally)
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

    if trace_on:
        out["reading"] = trace.read(tr["prof"], tr["frames"], tr["window_ms"], tr["enqueue_ms"])
        samples = [gather.planes(program.planes(s)) for s in tr.pop("samples")]
        del tr
    whole_init = gather.planes(program.planes(init))
    whole_in, whole_out = gather.planes(program.planes(s_in)), gather.planes(program.planes(s_out))
    del init, s_in, s_out
    if not first:
        return out

    judge = model.Judge(cfg, bench, image=entry.IMAGE)
    image = aux if entry.IMAGE else None
    out["numbers"] = judge.numbers(make_particles(), whole_init, whole_in, whole_out, image, lost)
    del whole_init
    if trace_on:
        out["reading"].work = judge.census(samples, whole_out)
        del samples
    if control:
        out["control_numbers"] = judge.control(whole_in)
    return out
