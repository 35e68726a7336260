"""Ghost-row exchange between neighbour bands: point-to-point sends and receives.

Counterpart of ``rust_particle_system_tpu/parallel/sharded_step.py::
exchange_halo`` (two ``ppermute`` rings).  Here each exchange is one
``batch_isend_irecv`` with at most one buffer per direction: the caller packs
every channel of an exchange point into it (JAX issues one ``ppermute`` per
channel).  The mesh's edge bands have no neighbour on one side and receive
nothing there; the callers fill those ghost rows with the channel's fill, so
no validity mask is exchanged (JAX exchanges masks because a ``ppermute``
delivers zeros at the edges).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..runtime.profiling import span
from .mesh import BandMesh


def exchange_halo(top, bottom, mesh: BandMesh):
    """Send ``top`` (this band's rows next to the band above) up and ``bottom``
    (its rows next to the band below) down; return ``(lo, hi)``: the band
    below's ``top`` and the band above's ``bottom``, ``None`` past the mesh's
    edges.  A ``None`` payload is neither sent nor received; every band passes
    payloads of the same shapes, or the same ``None``s.  A ``sph.halo`` span;
    what arrives is counted on ``mesh.received`` by the side it came from."""
    up, down = mesh.rank + 1, mesh.rank - 1
    wire = mesh.wire
    ops, lo, hi = [], None, None

    def send(t, peer):
        ops.append(dist.P2POp(dist.isend, t.to(wire).contiguous(), peer, mesh.group))

    def recv(like, peer, side):
        buf = torch.empty(like.shape, dtype=like.dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
        mesh.count(side, buf)
        return buf

    with span("sph.halo"):
        if up < mesh.size:
            if top is not None:
                send(top, up)
            if bottom is not None:
                hi = recv(bottom, up, "above")
        if down >= 0:
            if bottom is not None:
                send(bottom, down)
            if top is not None:
                lo = recv(top, down, "below")
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return (None if lo is None else lo.to(mesh.device),
                None if hi is None else hi.to(mesh.device))


def _rows(planes, r: int) -> torch.Tensor:
    """Row ``r`` of each plane, packed into one ``[len(planes), gw, C]`` buffer."""
    return torch.stack([p[r] for p in planes])


def _or_fills(got, planes, fills) -> torch.Tensor:
    """The received rows, or rows of each channel's fill past the mesh's edge."""
    if got is not None:
        return got
    return torch.stack([torch.full_like(p[0], f) for p, f in zip(planes, fills)])


def rebin_halo(chans, fills, mesh: BandMesh):
    """The band rebin's ghost rows ``(lo2, lo1, hi1)`` (see
    :func:`~rust_particle_system_tpu_torch.ops.cuda.rebin.rebin_planes_band`)
    in one exchange: up go the top row of every channel and, when the band has
    two rows or more, the x/y of the row below it; down goes the bottom row of
    every channel.  With one row per band, global row row0-2 lives two bands
    down and comes up in a second hop, as in JAX (plane_sharded.py:123-129).
    Past the mesh's edges the ghost rows hold the fills."""
    R, k = chans[0].shape[0], len(chans)
    top = _rows(chans, R - 1)
    if R >= 2:
        top = torch.cat([top, _rows(chans[:2], R - 2)])
    lo, hi = exchange_halo(top, _rows(chans, 0), mesh)
    lo1 = _or_fills(None if lo is None else lo[:k], chans, fills)
    if R >= 2:
        lo2 = _or_fills(None if lo is None else lo[k:], chans[:2], fills)
    else:
        lo2 = _or_fills(exchange_halo(lo1[:2], None, mesh)[0], chans[:2], fills)
    return lo2, lo1, _or_fills(hi, chans, fills)


def edge_rows(planes, fills, mesh: BandMesh):
    """``(lo, hi)``, each ``[len(planes), gw, C]``: the band below's top row and
    the band above's bottom row of every ``[R, gw, C]`` plane, in one
    exchange; the fill past the mesh's edges."""
    lo, hi = exchange_halo(_rows(planes, -1), _rows(planes, 0), mesh)
    return _or_fills(lo, planes, fills), _or_fills(hi, planes, fills)


def halo_rows(planes, fills, mesh: BandMesh) -> list:
    """The walks' halo: each ``[R, gw, C]`` plane with the neighbour bands'
    edge rows on each side (``[R + 2, gw, C]``), in one exchange for all the
    planes; the fill past the mesh's edges."""
    lo, hi = edge_rows(planes, fills, mesh)
    return [torch.cat([lo[i:i + 1], p, hi[i:i + 1]]) for i, p in enumerate(planes)]
