"""The 2D SPH fluid on plane-resident state.

Counterpart of ``rust_particle_system_tpu/models/sph.py`` with
``backend="pallas"`` and its settle-safe default layout: aspect-1 cells the size
of the smoothing radius, 128 slots per cell, one cell per slot row.  State is a
:class:`~..ops.cuda.resident.PlaneState` carried across frames and re-binned
each frame by the lossless rebin; nothing is ever sorted after init.

Rendering is not ported yet (ROADMAP Queue 1 #7): ``render`` and
``step_and_render`` raise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import DEFAULT_BOUNDS, PARTICLE_COUNT, SimParams, make_params
from ..core.state import scatter_init
from ..ops.cuda.resident import PlaneState, plane_state_from_particles, plane_step
from ..ops.grid import GridSpec

DEFAULT_CAPACITY = 128
_RENDER_TODO = ("rendering is not ported yet (ROADMAP Queue 1 #7: the "
                "row-strip rasterizer K4 and plane_frame)")


@dataclasses.dataclass(frozen=True)
class SPHFluid:
    grid: GridSpec
    bounds: tuple
    device: torch.device
    n: int = PARTICLE_COUNT

    @classmethod
    def create(cls, n: int = PARTICLE_COUNT, bounds=DEFAULT_BOUNDS,
               cell_size: float | None = None, capacity: int | None = None,
               device="cuda") -> "SPHFluid":
        """``capacity=None`` takes the settle-safe 128 slots per cell (a settled
        pool runs ~101 particles per cell under the default parameters).  The
        default device is the card; there is no silent CPU fallback."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SPHFluid.create: device 'cuda' requested but torch.cuda is not "
                "available; pass device='cpu' to run the plain PyTorch versions")
        params = make_params(bounds=bounds)
        if cell_size is None:
            # cell size = smoothing radius, as the reference ties them (main.rs:88)
            cell_size = params.smoothing_radius
        cap = DEFAULT_CAPACITY if capacity is None else int(capacity)
        grid = GridSpec.from_bounds(bounds, cell_size, cap)
        return cls(grid=grid, bounds=tuple(float(b) for b in bounds),
                   device=device, n=int(n))

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

    def render(self, state, params, camera=None):
        raise NotImplementedError(_RENDER_TODO)

    def step_and_render(self, state, params):
        raise NotImplementedError(_RENDER_TODO)
