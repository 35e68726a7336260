"""The 2D SPH fluid, behind the JAX package's backends.

Counterpart of ``rust_particle_system_tpu/models/sph.py``.  ``backend``:

* ``"pallas"`` (and ``"auto"``): the plane-resident path.  Aspect-1 cells the
  size of the smoothing radius, with the settle-safe default of 128 slots per
  cell walked one cell per block (K2, K3), or the opt-in pair-packed layout of
  at most 64 slots per cell walked two cells per block (K6).  State is a
  :class:`~..ops.cuda.resident.PlaneState` carried across frames and re-binned
  each frame by the lossless rebin; nothing is sorted after init.  Renders
  draw the planes through the plane rasterizer (K4) with no binning.  On the
  CPU the same path runs through the kernels' plain versions, so ``"auto"``
  picks it on every device (JAX's ``"auto"`` picks ``"grid"`` off the TPU).
* ``"grid"``: the sort-binned step in plain PyTorch (``ops/grid_step.py``),
  capacity from :func:`~..ops.grid.suggest_capacity`.
* ``"oracle"``: the all-pairs O(n^2) step (``ops/reference_step.py``), no grid.

The grid and oracle backends carry a ``ParticleState`` and render through the
general splat.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import DEFAULT_BOUNDS, PARTICLE_COUNT, SimParams, make_params
from ..core.state import scatter_init
from ..ops.cuda.resident import (PlaneState, plane_frame, plane_state_from_particles,
                                 plane_step, render_plane_state)
from ..ops.grid import GridSpec, suggest_capacity
from ..ops.grid_step import grid_step
from ..ops.reference_step import reference_step
from ..render import RenderSpec, splat
from ..render.splat_planes import MARGIN, planes_compatible
from .base import model_device

DEFAULT_CAPACITY = 128
BACKENDS = ("auto", "pallas", "grid", "oracle")


@dataclasses.dataclass(frozen=True)
class SPHFluid:
    grid: GridSpec | None
    render_spec: RenderSpec
    bounds: tuple
    device: torch.device
    n: int = PARTICLE_COUNT
    backend: str = "pallas"

    @classmethod
    def create(cls, n: int = PARTICLE_COUNT, bounds=DEFAULT_BOUNDS,
               cell_size: float | None = None, capacity: int | None = None,
               pack2: bool = False, device="cuda",
               render_spec: RenderSpec | None = None, backend: str = "auto",
               capacity_safety: float = 16.0) -> "SPHFluid":
        """``backend`` is one of ``"auto"`` (= ``"pallas"``), ``"pallas"``,
        ``"grid"``, ``"oracle"``.  For ``"pallas"``, ``capacity=None`` takes
        the settle-safe 128 slots per cell (a settled pool runs ~101 particles
        per cell under the default parameters) and ignores ``pack2``;
        ``capacity=64, pack2=True`` is the pair-packed layout, for states that
        stay under 64 particles per cell.  For ``"grid"``, ``capacity=None``
        takes ``suggest_capacity(n, bounds, cell_size, capacity_safety)``.  The
        default device is the card; there is no silent CPU fallback."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        backend = "pallas" if backend == "auto" else backend
        device = model_device(device, "SPHFluid.create")
        params = make_params(bounds=bounds)
        if cell_size is None:
            # cell size = smoothing radius, as the reference ties them (main.rs:88)
            cell_size = params.smoothing_radius
        grid = None
        if backend == "grid":
            if capacity is None:
                capacity = suggest_capacity(n, bounds, cell_size, safety=capacity_safety)
            grid = GridSpec.from_bounds(bounds, cell_size, int(capacity))
        elif backend == "pallas":
            if capacity is None:
                grid = GridSpec.from_bounds(bounds, cell_size, DEFAULT_CAPACITY)
            else:
                grid = GridSpec.from_bounds(bounds, cell_size, int(capacity), pack2=pack2)
        return cls(grid=grid, render_spec=render_spec or RenderSpec(),
                   bounds=tuple(float(b) for b in bounds), device=device, n=int(n),
                   backend=backend)

    def default_params(self) -> SimParams:
        return make_params(bounds=self.bounds)

    def init(self, generator: torch.Generator, n: int):
        """Scatter ``n`` particles (reference initializer).  The pallas backend
        bins them into planes: the only sort its simulation ever runs."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        state = scatter_init(generator, n, self.bounds)
        if self.backend == "pallas":
            return plane_state_from_particles(state, self.grid)
        return state

    def step(self, state, params: SimParams):
        if self.backend == "pallas":
            return plane_step(state, params, self.grid)
        if self.backend == "grid":
            return grid_step(state, params, self.grid)
        return reference_step(state, params)

    def render(self, state, params: SimParams, camera=None):
        """The [H, W, 4] image of ``state``; ``camera`` is a (cx, cy, zoom)
        pan/zoom triple.

        The pallas backend with the identity camera, on a geometry that meets
        the plane rasterizer's preconditions, renders the planes directly (K4,
        no binning).  Any other backend, camera or geometry takes the general
        splat of the id-ordered particles, on the state's own device, as the
        JAX model routes it."""
        if self.backend == "pallas" and camera is None:
            margin = min(MARGIN, self.render_spec.max_radius_px)
            if planes_compatible(self.grid, self.render_spec, self.bounds, margin):
                return render_plane_state(state, params, self.grid, self.render_spec,
                                          bounds_static=self.bounds)
        ps = state.to_particle_state(params) if isinstance(state, PlaneState) else state
        return splat(ps.pos, ps.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)

    def step_and_render(self, state, params: SimParams):
        """One frame and its image.  The pallas backend fuses them (physics,
        then the image of the end planes); the others step, then render.
        Returns (state, image)."""
        if self.backend != "pallas":
            new = self.step(state, params)
            return new, self.render(new, params)
        return plane_frame(state, params, self.grid, self.render_spec,
                           bounds_static=self.bounds)
