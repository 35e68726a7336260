"""All-pairs N-body attraction with a repulsive core.

Counterpart of ``rust_particle_system_tpu/models/nbody.py``.  The acceleration
on particle i is a softened pull plus a shorter-range repulsion,

    a_i = sum_j dir_ij * (G / (d^2 + eps^2) - R eps / (d^2 + eps^2)^1.5),

so clusters form without collapse.  ``nbody_step`` takes it from
:func:`~..ops.cuda.nbody.nbody_accel`, which launches kernel K8 on the card
and runs the dense plain version on the CPU; the model's device picks which
(JAX's ``backend``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import kernels as K
from ..core.params import DEFAULT_BOUNDS, F32Params
from ..core.state import ParticleState, make_state
from ..ops.cuda.nbody import nbody_accel, pairwise_accel
from ..render import RenderSpec, splat
from .base import model_device

__all__ = ["NBody", "NBodyParams", "make_nbody_params", "nbody_accel", "nbody_step",
           "pairwise_accel"]


@dataclasses.dataclass(frozen=True)
class NBodyParams(F32Params):
    dt: float
    g_const: float  # attraction strength
    repulsion: float  # repulsive-core strength
    softening: float  # eps
    damping_factor: float
    max_energy: float
    particle_size: float
    bounds: tuple


def make_nbody_params(*, dt=0.005, g_const=5_000.0, repulsion=50_000.0, softening=5.0,
                      damping_factor=0.9, max_energy=2_000.0, particle_size=2.0,
                      bounds=DEFAULT_BOUNDS) -> NBodyParams:
    return NBodyParams(dt=dt, g_const=g_const, repulsion=repulsion, softening=softening,
                       damping_factor=damping_factor, max_energy=max_energy,
                       particle_size=particle_size, bounds=tuple(bounds))


def nbody_step(state: ParticleState, params: NBodyParams) -> ParticleState:
    """Accelerate, Euler step, abs-damped bounce, energy colour."""
    accel = nbody_accel(state.pos, params)
    vel = state.vel + accel * params.dt
    pos = state.pos + vel * params.dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame + 1)


@dataclasses.dataclass(frozen=True)
class NBody:
    render_spec: RenderSpec
    bounds: tuple
    device: torch.device

    @classmethod
    def create(cls, bounds=DEFAULT_BOUNDS, render_spec=None, device="cuda") -> "NBody":
        return cls(render_spec=render_spec or RenderSpec(max_radius_px=3),
                   bounds=tuple(float(b) for b in bounds),
                   device=model_device(device, "NBody.create"))

    def default_params(self) -> NBodyParams:
        return make_nbody_params(bounds=self.bounds)

    def init(self, generator: torch.Generator, n: int) -> ParticleState:
        """A disc of particles around the centre, at rest."""
        x_min, x_max, y_min, y_max = self.bounds
        r_max = 0.4 * min(x_max - x_min, y_max - y_min)
        u = torch.rand((2, n), generator=generator, device=generator.device)
        r = r_max * torch.sqrt(u[0])
        theta = u[1] * (2.0 * math.pi)
        pos = torch.stack([r * torch.cos(theta) + (x_min + x_max) / 2,
                           r * torch.sin(theta) + (y_min + y_max) / 2], dim=-1)
        return make_state(pos)

    def step(self, state: ParticleState, params: NBodyParams) -> ParticleState:
        return nbody_step(state, params)

    def render(self, state: ParticleState, params: NBodyParams, camera=None):
        return splat(state.pos, state.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)
