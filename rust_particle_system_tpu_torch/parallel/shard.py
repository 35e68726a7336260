"""Band-sharded plane state: the grid padded to the bands, a rank's slab of it,
and the slabs gathered back.

Counterpart of the grid-padding part of ``rust_particle_system_tpu/parallel/
shard.py::make_shard_spec`` and of ``plane_sharded.py::shard_plane_state``,
and a rank's band binned from the particles (:func:`band_plane_state`).
The slot-stream fields of JAX's ``ShardSpec`` (``cap``, ``mig_cap``,
``mig_rounds``) belong to the legacy stream mesh, which is not ported, so
:func:`make_shard_spec` returns the padded grid alone.  JAX's sharded arrays
are global; here each rank holds its slab, and :func:`gather_plane_state`
assembles the whole state on every rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..core.state import ParticleState
from ..ops.cuda.resident import PlaneState, plane_state_from_particles
from ..ops.grid import GridSpec
from .mesh import BandMesh


def make_shard_spec(bounds, cell_size: float, capacity: int, n_bands: int,
                    pack2: bool = False) -> GridSpec:
    """The grid of ``bounds`` with its height padded up to a multiple of
    ``n_bands`` (the padded rows lie above the domain and stay empty)."""
    base = GridSpec.from_bounds(bounds, cell_size, capacity, pack2=pack2)
    return dataclasses.replace(base, gh=math.ceil(base.gh / n_bands) * n_bands)


def _band_rows(gh: int, mesh: BandMesh) -> slice:
    if gh % mesh.size:
        raise ValueError(f"grid height {gh} must divide by {mesh.size} bands; pad it "
                         f"with make_shard_spec")
    R = gh // mesh.size
    return slice(mesh.rank * R, (mesh.rank + 1) * R)


def shard_plane_state(ps: PlaneState, mesh: BandMesh) -> PlaneState:
    """This rank's band of a whole PlaneState: the rows ``[rank*R, (rank+1)*R)``
    of each plane, copied to the mesh's device; frame, lost and n as they are."""
    rows = _band_rows(ps.px.shape[0], mesh)
    band = {f: getattr(ps, f)[rows].to(mesh.device, copy=True)
            for f in ("px", "py", "vx", "vy", "idsf")}
    return PlaneState(**band, frame=ps.frame, lost=ps.lost.to(mesh.device), n=ps.n)


def band_plane_state(state: ParticleState, spec: GridSpec, mesh: BandMesh) -> PlaneState:
    """This rank's band of the initial binning of ``state`` on the padded grid
    ``spec``: ``shard_plane_state(plane_state_from_particles(state, spec),
    mesh)`` bit for bit, with only the band's rows built (every particle is
    still sorted and spilled over the whole grid), so no rank holds the whole
    grid's planes."""
    rows = _band_rows(spec.gh, mesh)
    return plane_state_from_particles(state, spec, rows=(rows.start, rows.stop))


def gather_plane_state(ps: PlaneState, mesh: BandMesh) -> PlaneState:
    """The whole PlaneState on every rank, from each rank's band (one
    all_gather of the five planes packed together)."""
    slab = torch.stack([ps.px, ps.py, ps.vx, ps.vy, ps.idsf]).to(mesh.wire)
    parts = [torch.empty_like(slab) for _ in range(mesh.size)]
    dist.all_gather(parts, slab, group=mesh.group)
    px, py, vx, vy, idsf = torch.cat(parts, dim=1).to(mesh.device)
    return PlaneState(px=px, py=py, vx=vx, vy=vy, idsf=idsf, frame=ps.frame,
                      lost=ps.lost, n=ps.n)
