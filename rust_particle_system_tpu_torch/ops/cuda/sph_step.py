"""The two walks on ``[gh, gw, C]`` planes, classic layout.

Counterpart of ``rust_particle_system_tpu/ops/pallas/sph_step.py::
_forces_from_cells`` (classic branch, sph_step.py:61-89).  The TPU's lane and
tile padding and ghost borders are layout mechanics of its kernels; the port's
kernels take the planes as they are.
"""

from __future__ import annotations

from ...core.params import SimParams
from ..grid import GridSpec
from .sph import density_planes, force_planes_integrated, pressure_terms


def _forces_from_cells(pxg, pyg, vxg, vyg, npx, npy, spec: GridSpec,
                       params: SimParams):
    """Density walk, pressure terms, then the fused force walk whose epilogue
    performs the frame tail.  ``npx``/``npy`` are the TRUE predicted positions
    (``pxg``/``pyg`` park deferred slots).  Returns the FINAL (px, py, vx, vy)
    planes.  Only this fused-tail walk is ported (the JAX ``integrate_planes``
    path); the raw-sum walk K3b brings its own entry when it is."""
    if spec.pack2:
        raise NotImplementedError(
            "the pair-packed (pack2) layout is not ported yet; use the classic "
            "layout (pack2=False)")
    rho, rhon = density_planes(pxg, pyg, params)
    P1, NPo, NPn = pressure_terms(rho, rhon, params)
    return force_planes_integrated(pxg, pyg, P1, NPn, vxg, vyg, NPo, npx, npy,
                                   params)
