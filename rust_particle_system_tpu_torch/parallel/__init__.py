"""The band-sharded mesh: one process per band of cell rows (torch.distributed).

Counterpart of ``rust_particle_system_tpu/parallel/`` for the plane-resident
step: ``mesh`` (the band mesh and a one-host world launcher), ``halo`` (the
ghost-row exchanges), ``shard`` (the padded grid, a rank's slab, the gather)
and ``plane_sharded`` (the sharded step and rendered frame).  The legacy
stream mesh (``sharded_step.py`` apart from ``exchange_halo``) and its
``composite.py`` are not ported.
"""

from .halo import exchange_halo
from .mesh import BandMesh, make_band_mesh, run_bands
from .plane_sharded import (DIAGS, check_plane_diags, make_plane_sharded_frame,
                            make_plane_sharded_step)
from .shard import band_plane_state, gather_plane_state, make_shard_spec, shard_plane_state

__all__ = [
    "BandMesh",
    "DIAGS",
    "band_plane_state",
    "check_plane_diags",
    "exchange_halo",
    "gather_plane_state",
    "make_band_mesh",
    "make_plane_sharded_frame",
    "make_plane_sharded_step",
    "make_shard_spec",
    "run_bands",
    "shard_plane_state",
]
