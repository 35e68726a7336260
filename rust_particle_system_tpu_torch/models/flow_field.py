"""Curl-noise flow-field advection.

Counterpart of ``rust_particle_system_tpu/models/flow_field.py``.  The velocity
field is the curl of an analytic sum-of-octaves potential psi(x, t),

    flow(x, t) = (d psi / dy, -d psi / dx),

divergence-free by construction, so particles swirl without clumping.  The
step is elementwise torch (field, drag, Euler, periodic wrap, colour): no
kernel of its own.  Scalars are formed in float32, as JAX forms them from its
f32 parameters.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import kernels as K
from ..core.params import DEFAULT_BOUNDS, F32Params, f32_mul
from ..core.state import ParticleState, make_state
from ..render import RenderSpec, splat
from .base import model_device

N_OCTAVES = 4


@dataclasses.dataclass(frozen=True)
class FlowFieldParams(F32Params):
    dt: float
    flow_strength: float  # scales the curl velocity field
    drag: float  # relaxation rate toward the field velocity
    noise_scale: float  # base spatial wavelength
    time_scale: float  # field animation speed
    max_energy: float
    particle_size: float
    bounds: tuple
    octave_dirs: tuple  # N_OCTAVES unit wave vectors (x, y)
    octave_phases: tuple  # N_OCTAVES
    octave_speeds: tuple  # N_OCTAVES


def make_flow_params(*, dt=0.01, flow_strength=250.0, drag=4.0, noise_scale=300.0,
                     time_scale=1.0, max_energy=2_000.0, particle_size=2.0,
                     bounds=DEFAULT_BOUNDS, seed: int = 0) -> FlowFieldParams:
    """The octave tables are drawn from a ``torch.Generator`` seeded with
    ``seed``: the same distributions as JAX's, other numbers."""
    gen = torch.Generator().manual_seed(seed)
    angles = torch.rand(N_OCTAVES, generator=gen) * (2.0 * math.pi)
    phases = torch.rand(N_OCTAVES, generator=gen) * (2.0 * math.pi)
    speeds = 0.5 + torch.rand(N_OCTAVES, generator=gen) * 1.5
    dirs = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    return FlowFieldParams(
        dt=dt, flow_strength=flow_strength, drag=drag, noise_scale=noise_scale,
        time_scale=time_scale, max_energy=max_energy, particle_size=particle_size,
        bounds=tuple(bounds), octave_dirs=tuple(map(tuple, dirs.tolist())),
        octave_phases=tuple(phases.tolist()), octave_speeds=tuple(speeds.tolist()))


def curl_velocity(pos, t: float, params: FlowFieldParams):
    """Analytic curl of the layered-sine potential at ``[n, 2]`` positions:
    psi = sum_o (A / 2^o) sin(k_o . x / (L / 2^o) + phi_o + omega_o t)."""
    f = np.float32
    vx = torch.zeros_like(pos[:, 0])
    vy = torch.zeros_like(pos[:, 0])
    for o in range(N_OCTAVES):
        wavelength = f(params.noise_scale) / f(2.0 ** o)
        amp = f(params.flow_strength) * wavelength / f(params.noise_scale)
        kx, ky = (f(d) / wavelength for d in params.octave_dirs[o])
        drift = f(params.octave_speeds[o]) * f(params.time_scale) * f(t)
        phase = (pos[:, 0] * float(kx) + pos[:, 1] * float(ky)
                 + params.octave_phases[o] + float(drift))
        c = torch.cos(phase)
        vx = vx + c * float(ky) * float(amp) * float(wavelength)
        vy = vy - c * float(kx) * float(amp) * float(wavelength)
    return torch.stack([vx, vy], dim=-1)


def _wrap(pos, bounds):
    """Periodic wrap (flow fields advect forever; walls would pile particles
    up).  ``jnp.mod`` is a floor-mod: ``torch.remainder``."""
    x_min, x_max, y_min, y_max = bounds
    w = float(np.float32(x_max) - np.float32(x_min))
    h = float(np.float32(y_max) - np.float32(y_min))
    x = torch.remainder(pos[:, 0] - x_min, w) + x_min
    y = torch.remainder(pos[:, 1] - y_min, h) + y_min
    return torch.stack([x, y], dim=-1)


def flow_step(state: ParticleState, params: FlowFieldParams) -> ParticleState:
    t = f32_mul(state.frame, params.dt)
    field = curl_velocity(state.pos, t, params)
    # velocity relaxes toward the field: dv = drag (field - v) dt
    vel = state.vel + params.drag * (field - state.vel) * params.dt
    pos = _wrap(state.pos + vel * params.dt, params.bounds)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame + 1)


@dataclasses.dataclass(frozen=True)
class FlowField:
    render_spec: RenderSpec
    bounds: tuple
    device: torch.device

    @classmethod
    def create(cls, bounds=DEFAULT_BOUNDS, render_spec=None, device="cuda") -> "FlowField":
        return cls(render_spec=render_spec or RenderSpec(max_radius_px=3),
                   bounds=tuple(float(b) for b in bounds),
                   device=model_device(device, "FlowField.create"))

    def default_params(self) -> FlowFieldParams:
        return make_flow_params(bounds=self.bounds)

    def init(self, generator: torch.Generator, n: int) -> ParticleState:
        """A uniform scatter over the whole domain (flow fields want full
        coverage), at rest."""
        x_min, x_max, y_min, y_max = self.bounds
        u = torch.rand((2, n), generator=generator, device=generator.device)
        return make_state(torch.stack([x_min + u[0] * (x_max - x_min),
                                       y_min + u[1] * (y_max - y_min)], dim=-1))

    def step(self, state: ParticleState, params: FlowFieldParams) -> ParticleState:
        return flow_step(state, params)

    def render(self, state: ParticleState, params: FlowFieldParams, camera=None):
        return splat(state.pos, state.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)
