"""The two walks on ``[gh, gw, C]`` planes, in either layout.

Counterpart of ``rust_particle_system_tpu/ops/pallas/sph_step.py::
_forces_from_cells`` as two entries: the fused-tail walk (``integrate_planes``
given: K3, or K6 for ``spec.pack2``) and the unfused one (K3b, or K6).  Both
start with the density walk K2 (or K6) in its pressure epilogue, which
writes the force walk's per-slot terms (P1, NPo, NPn) in place of JAX's
(rho, rhon) and the terms it computes from them after the walk.  The
TPU's lane and tile padding, ghost borders and A/B pair packing are layout
mechanics of its kernels; the port's kernels take the planes as they are, and
the pair-packed layout is a block shape of the same walks (``csrc/sph.cu``).

``halo``, as in JAX, gives the walks the ghost rows of a band's slab on the
band-sharded mesh: a callable ``(planes, fills) -> planes`` that returns each
``[R, gw, C]`` plane with one ghost row on each side (``[R + 2, gw, C]``).  It
takes every plane of one exchange at once (JAX's callback takes one), so the
mesh sends one buffer per direction for each.  The walks then serve the own
rows only; ``None`` (one device) walks the planes as they are.

The walks run under the frame's ``sph.density`` and ``sph.force`` spans, the
pressure terms' ghost rows under ``sph.pressure`` (on one device it holds no
work).
"""

from __future__ import annotations

from ...core.params import SimParams
from ...runtime.profiling import span
from ..grid import GridSpec
from .rebin import SENTINEL
from .sph import (density_pressure_pairs, density_pressure_planes, force_pairs,
                  force_pairs_integrated, force_planes, force_planes_integrated,
                  force_scalars)


def _walks(spec: GridSpec):
    """(density with pressure terms, fused force, raw force) walks of
    ``spec``'s layout."""
    if spec.pack2:
        return density_pressure_pairs, force_pairs_integrated, force_pairs
    return density_pressure_planes, force_planes_integrated, force_planes


def _neighbour_side(pxg, pyg, vxg, vyg, spec: GridSpec, params: SimParams, halo):
    """The force walk's neighbour-side planes (px, py, P1, NPn, vx, vy), with
    ghost rows from ``halo`` if given, and the own-side NPo: the density walk
    with the pressure terms in its epilogue, with their two exchanges."""
    density = _walks(spec)[0]
    ghost = halo is not None
    grown = (lambda planes, fills: list(planes)) if halo is None else halo
    with span("sph.density"):
        wx, wy, wvx, wvy = grown((pxg, pyg, vxg, vyg), (SENTINEL, SENTINEL, 0.0, 0.0))
        P1, NPo, NPn = density(wx, wy, params, ghost=ghost)
    with span("sph.pressure"):
        P1, NPn = grown((P1, NPn), (0.0, 0.0))
    return (wx, wy, P1, NPn, wvx, wvy), NPo


def _forces_from_cells(pxg, pyg, vxg, vyg, npx, npy, spec: GridSpec,
                       params: SimParams, halo=None):
    """Density walk with the pressure terms, then the fused force walk whose
    epilogue performs the frame tail.  ``npx``/``npy`` are the TRUE predicted
    positions (``pxg``/``pyg`` park deferred slots).  Returns the FINAL (px,
    py, vx, vy) planes."""
    nbr, NPo = _neighbour_side(pxg, pyg, vxg, vyg, spec, params, halo)
    with span("sph.force"):
        return _walks(spec)[1](*nbr, NPo, npx, npy, params, ghost=halo is not None)


def _velocities_from_cells(pxg, pyg, vxg, vyg, spec: GridSpec, params: SimParams,
                           halo=None):
    """The unfused walk (the JAX entry without ``integrate_planes``): density
    walk with the pressure terms, raw force walk (K3b or K6), then the velocity
    update ``v + f*dt + fv*vscale``.  Returns (nvx, nvy); values at slots whose walk
    position is parked are meaningless (the caller restores or parks them)."""
    nbr, NPo = _neighbour_side(pxg, pyg, vxg, vyg, spec, params, halo)
    with span("sph.force"):
        fx, fy, fvx, fvy = _walks(spec)[2](*nbr, NPo, params, ghost=halo is not None)
        dt, vscale = params.dt, force_scalars(params)[3]
        return vxg + fx * dt + fvx * vscale, vyg + fy * dt + fvy * vscale
