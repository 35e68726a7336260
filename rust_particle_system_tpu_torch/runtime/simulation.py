"""Simulation driver: a host loop over frames, with live-tunable parameters.

Counterpart of ``rust_particle_system_tpu/runtime/simulation.py``.  PyTorch runs
eagerly, so the driver is a plain host loop: each frame enqueues its kernels on
the current stream and returns without waiting for the card.  ``update_params``
is the egui-slider analog (`src/parameter_gui.rs:78-103`): the next frame
simply passes the new scalars by value.  Any model family drives through it:
the SPH fluid's pallas backend carries a ``PlaneState``, its grid and oracle
backends and the other models a ``ParticleState``.
"""

from __future__ import annotations

import torch

from ..core.params import SimParams, with_smoothing_radius
from ..ops.cuda.resident import PlaneState
from ..ops.grid import build_grid

# Tunable-parameter guardrails, mirroring the reference's egui slider ranges
# (src/parameter_gui.rs:38-70).  Keys not listed are unconstrained.
PARAM_RANGES = {
    "dt": (0.0015, 0.015),
    "gravity": (0.0, 1000.0),
    "damping_factor": (0.0, 1.0),
    "smoothing_radius": (1e-6, 30.0),  # exclusive 0: norms divide by h^5..h^8
    "max_energy": (1000.0, 10000.0),
    "target_density": (0.0, 0.1),
    "pressure_multiplier": (1.0, 100000.0),
    "viscosity_strength": (0.0, 10.0),
    "near_density_multiplier": (1.0, 10000.0),
}


def check_param_ranges(**kwargs) -> None:
    """Raise ValueError for any tunable outside its reference slider range."""
    for k, v in kwargs.items():
        rng = PARAM_RANGES.get(k)
        if rng is None:
            continue
        lo, hi = rng
        v = float(v)
        if not (lo <= v <= hi):
            raise ValueError(
                f"{k}={v} is outside the supported range [{lo}, {hi}] "
                f"(the reference GUI clamps it there, src/parameter_gui.rs:38-70)")


class Simulation:
    """Host-side wrapper: model + live-tunable params + device state."""

    def __init__(self, model, n: int | None = None, seed: int = 0, params=None):
        """``n`` defaults to the model's own count (``SPHFluid.n``); the other
        model families take it here."""
        self.model = model
        self.n = int(model.n if n is None else n)
        self.params = params if params is not None else model.default_params()
        gen = torch.Generator(device=model.device).manual_seed(seed)
        self.state = model.init(gen, self.n)

    def update_params(self, **kwargs):
        check_param_ranges(**kwargs)
        if "smoothing_radius" in kwargs and isinstance(self.params, SimParams):
            radius = float(kwargs.pop("smoothing_radius"))
            grid = getattr(self.model, "grid", None)
            if grid is not None and radius > min(grid.cell_size, grid.cell_width):
                # The 3x3 neighbourhood sees one cell in every direction: a radius
                # above the cell size would silently miss interactions.
                raise ValueError(
                    f"smoothing_radius {radius} exceeds the grid cell size "
                    f"{min(grid.cell_size, grid.cell_width)}; rebuild the model with "
                    f"a larger cell_size to raise the radius (lowering it is free)")
            self.params = with_smoothing_radius(self.params, radius)
        if kwargs:
            unknown = [k for k in kwargs if not hasattr(self.params, k)]
            if unknown:
                raise ValueError(f"unknown parameter(s): {unknown}")
            self.params = self.params.replace(**kwargs)
        return self.params

    def run(self, num_frames: int):
        """Advance ``num_frames`` frames (enqueued; no device sync)."""
        for _ in range(num_frames):
            self.state = self.model.step(self.state, self.params)
        return self.state

    def render(self, camera=None):
        """The [H, W, 4] image of the current state; ``camera`` is an optional
        (cx, cy, zoom) pan/zoom triple (the per-frame view_proj analog,
        src/particle_buffers.rs:220-236)."""
        return self.model.render(self.state, self.params, camera=camera)

    def particle_state(self):
        """The current state as a ParticleState: plane states convert to live
        rows in original-id order (lost rows trimmed); particle states are
        returned as they are."""
        if not isinstance(self.state, PlaneState):
            return self.state
        full = self.state.to_particle_state(self.params)
        n_live = self.n - int(self.state.lost)
        return type(full)(pos=full.pos[:n_live], vel=full.vel[:n_live],
                          color=full.color[:n_live], frame=full.frame,
                          ids=full.ids[:n_live])

    def stats(self) -> dict:
        """Validate the current state and return summary statistics; raises
        ValueError on violated invariants.  Models with a grid also report its
        occupancy and overflow (``validate_grid`` of the current state's
        binning, keys ``grid_*``); plane states report ``lost`` and raise on
        any lost particle."""
        from .debug import validate_grid, validate_state

        pstate = self.particle_state()
        out = validate_state(pstate, self.params)
        spec = getattr(self.model, "grid", None)
        if spec is not None:
            grid = build_grid(spec, pstate.pos)
            gstats = validate_grid(grid, spec, pstate.n)
            out.update({f"grid_{k}": v for k, v in gstats.items()})
        if not isinstance(self.state, PlaneState):
            return out
        lost = int(self.state.lost)
        out["lost"] = lost
        if lost:
            raise ValueError(
                f"plane-resident state has dropped {lost} particles at the initial "
                f"binning; raise the grid capacity")
        return out
