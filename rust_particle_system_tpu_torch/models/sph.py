"""The 2D SPH fluid on plane-resident state.

Counterpart of ``rust_particle_system_tpu/models/sph.py`` with
``backend="pallas"``: aspect-1 cells the size of the smoothing radius, with the
settle-safe default of 128 slots per cell walked one cell per block (K2, K3),
or the opt-in pair-packed layout of at most 64 slots per cell walked two cells
per block (K6).  State is a
:class:`~..ops.cuda.resident.PlaneState` carried across frames and re-binned
each frame by the lossless rebin; nothing is ever sorted after init.  Renders
draw the planes through the plane rasterizer (K4) with no binning.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import DEFAULT_BOUNDS, PARTICLE_COUNT, SimParams, make_params
from ..core.state import scatter_init
from ..ops.cuda.resident import (PlaneState, plane_frame, plane_state_from_particles,
                                 plane_step, render_plane_state)
from ..ops.grid import GridSpec
from ..render import RenderSpec, splat
from ..render.splat_planes import MARGIN, planes_compatible
from .base import model_device

DEFAULT_CAPACITY = 128


@dataclasses.dataclass(frozen=True)
class SPHFluid:
    grid: GridSpec
    render_spec: RenderSpec
    bounds: tuple
    device: torch.device
    n: int = PARTICLE_COUNT

    @classmethod
    def create(cls, n: int = PARTICLE_COUNT, bounds=DEFAULT_BOUNDS,
               cell_size: float | None = None, capacity: int | None = None,
               pack2: bool = False, device="cuda",
               render_spec: RenderSpec | None = None) -> "SPHFluid":
        """``capacity=None`` takes the settle-safe 128 slots per cell (a settled
        pool runs ~101 particles per cell under the default parameters) and
        ignores ``pack2``.  ``capacity=64, pack2=True`` is the pair-packed
        layout, for states that stay under 64 particles per cell (a uniform
        scatter; the JAX package's headline configuration).  The default device
        is the card; there is no silent CPU fallback."""
        device = model_device(device, "SPHFluid")
        params = make_params(bounds=bounds)
        if cell_size is None:
            # cell size = smoothing radius, as the reference ties them (main.rs:88)
            cell_size = params.smoothing_radius
        if capacity is None:
            grid = GridSpec.from_bounds(bounds, cell_size, DEFAULT_CAPACITY)
        else:
            grid = GridSpec.from_bounds(bounds, cell_size, int(capacity), pack2=pack2)
        return cls(grid=grid, render_spec=render_spec or RenderSpec(),
                   bounds=tuple(float(b) for b in bounds), device=device, n=int(n))

    def default_params(self) -> SimParams:
        return make_params(bounds=self.bounds)

    def init(self, generator: torch.Generator, n: int) -> PlaneState:
        """Scatter ``n`` particles (reference initializer) and bin them into
        planes: the only sort the simulation ever runs."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        state = scatter_init(generator, n, self.bounds)
        return plane_state_from_particles(state, self.grid)

    def step(self, state: PlaneState, params: SimParams) -> PlaneState:
        return plane_step(state, params, self.grid)

    def render(self, state: PlaneState, params: SimParams, camera=None):
        """The [H, W, 4] image of ``state``; ``camera`` is a (cx, cy, zoom)
        pan/zoom triple.

        The identity camera on a geometry that meets the plane rasterizer's
        preconditions renders the planes directly (K4, no binning).  Any
        other camera or geometry takes the general splat of the id-ordered
        particles, on the state's own device, as the JAX model routes it."""
        if camera is None:
            margin = min(MARGIN, self.render_spec.max_radius_px)
            if planes_compatible(self.grid, self.render_spec, self.bounds, margin):
                return render_plane_state(state, params, self.grid, self.render_spec,
                                          bounds_static=self.bounds)
        ps = state.to_particle_state(params)
        return splat(ps.pos, ps.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)

    def step_and_render(self, state: PlaneState, params: SimParams):
        """Fused frame: physics, then the image of the end planes.  Returns
        (state, image)."""
        return plane_frame(state, params, self.grid, self.render_spec,
                           bounds_static=self.bounds)
