"""The two walks on ``[gh, gw, C]`` planes, classic layout.

Counterpart of ``rust_particle_system_tpu/ops/pallas/sph_step.py::
_forces_from_cells`` (classic branch, sph_step.py:61-93), as two entries: the
fused-tail walk (``integrate_planes`` given, K3) and the unfused one (K3b).
The TPU's lane and tile padding and ghost borders are layout mechanics of its
kernels; the port's kernels take the planes as they are.
"""

from __future__ import annotations

from ...core.params import SimParams
from ..grid import GridSpec
from .sph import (density_planes, force_planes, force_planes_integrated,
                  force_scalars, pressure_terms)


def _pressure_inputs(pxg, pyg, spec: GridSpec, params: SimParams):
    """Density walk (K2) and the per-slot pressure terms (P1, NPo, NPn)."""
    if spec.pack2:
        raise NotImplementedError(
            "the pair-packed (pack2) layout is not ported yet; use the classic "
            "layout (pack2=False)")
    return pressure_terms(*density_planes(pxg, pyg, params), params)


def _forces_from_cells(pxg, pyg, vxg, vyg, npx, npy, spec: GridSpec,
                       params: SimParams):
    """Density walk, pressure terms, then the fused force walk whose epilogue
    performs the frame tail.  ``npx``/``npy`` are the TRUE predicted positions
    (``pxg``/``pyg`` park deferred slots).  Returns the FINAL (px, py, vx, vy)
    planes."""
    P1, NPo, NPn = _pressure_inputs(pxg, pyg, spec, params)
    return force_planes_integrated(pxg, pyg, P1, NPn, vxg, vyg, NPo, npx, npy,
                                   params)


def _velocities_from_cells(pxg, pyg, vxg, vyg, spec: GridSpec, params: SimParams):
    """The unfused walk (the JAX entry without ``integrate_planes``): density
    walk, pressure terms, raw force walk (K3b), then the velocity update
    ``v + f*dt + fv*vscale``.  Returns (nvx, nvy); values at slots whose walk
    position is parked are meaningless (the caller restores or parks them)."""
    P1, NPo, NPn = _pressure_inputs(pxg, pyg, spec, params)
    fx, fy, fvx, fvy = force_planes(pxg, pyg, P1, NPn, vxg, vyg, NPo, params)
    dt, vscale = params.dt, force_scalars(params)[3]
    return vxg + fx * dt + fvx * vscale, vyg + fy * dt + fvy * vscale
