"""The two walks on ``[gh, gw, C]`` planes, in either layout.

Counterpart of ``rust_particle_system_tpu/ops/pallas/sph_step.py::
_forces_from_cells`` as two entries: the fused-tail walk (``integrate_planes``
given: K3, or K6 for ``spec.pack2``) and the unfused one (K3b, or K6).  The
TPU's lane and tile padding, ghost borders and A/B pair packing are layout
mechanics of its kernels; the port's kernels take the planes as they are, and
the pair-packed layout is a block shape of the same walks (``csrc/sph.cu``).
"""

from __future__ import annotations

from ...core.params import SimParams
from ..grid import GridSpec
from .sph import (density_pairs, density_planes, force_pairs, force_pairs_integrated,
                  force_planes, force_planes_integrated, force_scalars,
                  pressure_terms)


def _walks(spec: GridSpec):
    """(density, fused force, raw force) walks of ``spec``'s layout."""
    if spec.pack2:
        return density_pairs, force_pairs_integrated, force_pairs
    return density_planes, force_planes_integrated, force_planes


def _forces_from_cells(pxg, pyg, vxg, vyg, npx, npy, spec: GridSpec,
                       params: SimParams):
    """Density walk, pressure terms, then the fused force walk whose epilogue
    performs the frame tail.  ``npx``/``npy`` are the TRUE predicted positions
    (``pxg``/``pyg`` park deferred slots).  Returns the FINAL (px, py, vx, vy)
    planes."""
    density, force_integrated, _ = _walks(spec)
    P1, NPo, NPn = pressure_terms(*density(pxg, pyg, params), params)
    return force_integrated(pxg, pyg, P1, NPn, vxg, vyg, NPo, npx, npy, params)


def _velocities_from_cells(pxg, pyg, vxg, vyg, spec: GridSpec, params: SimParams):
    """The unfused walk (the JAX entry without ``integrate_planes``): density
    walk, pressure terms, raw force walk (K3b or K6), then the velocity update
    ``v + f*dt + fv*vscale``.  Returns (nvx, nvy); values at slots whose walk
    position is parked are meaningless (the caller restores or parks them)."""
    density, _, force = _walks(spec)
    P1, NPo, NPn = pressure_terms(*density(pxg, pyg, params), params)
    fx, fy, fvx, fvy = force(pxg, pyg, P1, NPn, vxg, vyg, NPo, params)
    dt, vscale = params.dt, force_scalars(params)[3]
    return vxg + fx * dt + fvx * vscale, vyg + fy * dt + fvy * vscale
