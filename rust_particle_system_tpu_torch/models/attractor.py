"""Gravity plus a point attractor, explicit Euler, bounds bounce.

Counterpart of ``rust_particle_system_tpu/models/attractor.py``: the mouse
attractor, the interactive analog of dragging a cursor through the fluid.
The attractor's position is a parameter, fed by value every frame.  The step
is elementwise torch in JAX's order of operations (attractor.py:60-74): no
kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import kernels as K
from ..core.params import DEFAULT_BOUNDS, F32Params
from ..core.state import ParticleState, scatter_init
from ..render import RenderSpec, splat
from .base import model_device


@dataclasses.dataclass(frozen=True)
class AttractorParams(F32Params):
    dt: float
    gravity: float
    damping_factor: float
    max_energy: float
    particle_size: float
    bounds: tuple
    attractor_pos: tuple  # (x, y)
    attractor_strength: float  # > 0 attracts, < 0 repels
    attractor_falloff: float  # softening length


def make_attractor_params(*, dt=0.01, gravity=200.0, damping_factor=0.7,
                          max_energy=2_000.0, particle_size=3.0, bounds=DEFAULT_BOUNDS,
                          attractor_pos=(0.0, 0.0), attractor_strength=2_000.0,
                          attractor_falloff=200.0) -> AttractorParams:
    return AttractorParams(dt=dt, gravity=gravity, damping_factor=damping_factor,
                           max_energy=max_energy, particle_size=particle_size,
                           bounds=tuple(bounds), attractor_pos=tuple(attractor_pos),
                           attractor_strength=attractor_strength,
                           attractor_falloff=attractor_falloff)


def attractor_step(state: ParticleState, params: AttractorParams) -> ParticleState:
    """v += (g + attract) dt; x += v dt; bounce; colour."""
    delta = torch.stack([params.attractor_pos[0] - state.pos[:, 0],
                         params.attractor_pos[1] - state.pos[:, 1]], dim=-1)
    dist = torch.sqrt((delta * delta).sum(-1, keepdim=True))
    direction = delta / dist.clamp_min(1e-6)
    # Smooth inverse falloff: full strength inside `falloff`, ~1/d beyond it.
    magnitude = params.attractor_strength / (1.0 + dist / params.attractor_falloff)
    accel = direction * magnitude
    accel = torch.stack([accel[:, 0], accel[:, 1] - params.gravity], dim=-1)
    vel = state.vel + accel * params.dt
    pos = state.pos + vel * params.dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame + 1)


@dataclasses.dataclass(frozen=True)
class Attractor:
    render_spec: RenderSpec
    bounds: tuple
    device: torch.device

    @classmethod
    def create(cls, bounds=DEFAULT_BOUNDS, render_spec=None, device="cuda") -> "Attractor":
        return cls(render_spec=render_spec or RenderSpec(),
                   bounds=tuple(float(b) for b in bounds),
                   device=model_device(device, "Attractor.create"))

    def default_params(self) -> AttractorParams:
        return make_attractor_params(bounds=self.bounds)

    def init(self, generator: torch.Generator, n: int) -> ParticleState:
        return scatter_init(generator, n, self.bounds)

    def step(self, state: ParticleState, params: AttractorParams) -> ParticleState:
        return attractor_step(state, params)

    def render(self, state: ParticleState, params: AttractorParams, camera=None):
        return splat(state.pos, state.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)
