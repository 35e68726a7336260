"""All-pairs O(n^2) SPH step: the golden oracle for every faster path.

Counterpart of ``rust_particle_system_tpu/ops/reference_step.py``: the
bulk-synchronous restatement of the reference's per-frame schedule
(`src/particle_compute.rs:106-191`, `assets/compute_shader.wgsl`), with the
spatial grid replaced by an explicit all-pairs radius mask.  Each phase is a
global barrier:

1. gravity:    v += (0, -g) dt                          (compute_shader.wgsl:397-400)
2. predict:    p = pos + v dt                           (:402-405)
3. density:    (rho, rho_near) over p, self included    (:207-254)
4. forces:     F_p (pressure, self excluded) and
               F_v = sum (v_j - v_i) W_visc, both over p and the post-gravity
               velocities; v += F_p dt + strength F_v dt in one barrier
5. integrate:  pos += v dt                              (:392-395)
6. bounce:     clamp + damped reflect                   (:69-99)
7. colour:     kinetic-energy ramp                      (:101-118)

Reference quirks kept: the near-pressure term divides by rho_j * rho_near_j;
below distance 1e-4 the direction falls back to (0, 1); pairs count while
d^2 <= h^2; both phases no-op while ``frame < shader_delay`` (the frame still
advances).  Plain PyTorch, as the JAX version is plain XLA: it differentiates
end to end, and ``[n, n]`` temporaries bound it to small n.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core import kernels as K
from ..core.params import SimParams, f32_mul
from ..core.state import ParticleState

EPS_DIST = 1e-4  # direction-normalisation guard (compute_shader.wgsl:305)


@functools.lru_cache(maxsize=8)
def up_direction(device: torch.device) -> torch.Tensor:
    """The (0, 1) fallback direction on ``device``, copied there once per
    process (a per-frame copy from host memory would hold the host)."""
    return torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)


def safe_dist(sq):
    """sqrt of squared distances, with 0 where they are 0: the double where
    keeps reverse-mode gradients finite at d = 0 (sqrt'(0) is inf)."""
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, 1.0)), 0.0)


def pair_direction(delta, dist):
    """delta / dist, or (0, 1) where the pair essentially coincides."""
    far = dist > EPS_DIST
    safe = torch.where(far, dist, 1.0)
    return torch.where(far[..., None], delta / safe[..., None], up_direction(delta.device))


def pressure_pair_terms(p_i, p_j, np_i, np_j, rho_i, rho_j, rhon_j):
    """(pressure term, near term) of a pair; the near term keeps the
    reference's rho_j * rho_near_j denominator (compute_shader.wgsl:326-327)."""
    pressure_term = p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j)
    near_term = np_i / (rho_i * rho_i) + np_j / (rho_j * rhon_j)
    return pressure_term, near_term


def gravity_predict(state: ParticleState, params: SimParams):
    """(post-gravity velocity, predicted position)."""
    vel = torch.stack([state.vel[:, 0], state.vel[:, 1] - f32_mul(params.gravity, params.dt)],
                      dim=-1)
    return vel, state.pos + vel * params.dt


def integrate(state: ParticleState, vel, params: SimParams) -> ParticleState:
    """Integrate from the frame's start position, bounce, colour."""
    pos = state.pos + vel * params.dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return dataclasses.replace(state, pos=pos, vel=vel, color=color)


def _pairwise(pred):
    """delta[i, j] = pred[j] - pred[i], squared distance, distance."""
    delta = pred[None, :, :] - pred[:, None, :]
    sq = (delta * delta).sum(-1)
    return delta, sq, safe_dist(sq)


def all_pairs_density(pred, params: SimParams):
    """(rho, rho_near) per particle over predicted positions; self included."""
    _, sq, dist = _pairwise(pred)
    h = params.smoothing_radius
    in_radius = sq <= f32_mul(h, h)
    w = torch.where(in_radius, K.density_kernel(dist, h, params.density_kernel_norm), 0.0)
    wn = torch.where(in_radius,
                     K.near_density_kernel(dist, h, params.near_density_kernel_norm), 0.0)
    return w.sum(1), wn.sum(1)


def _not_self(n: int, device) -> torch.Tensor:
    return ~torch.eye(n, dtype=torch.bool, device=device)


def all_pairs_pressure_force(pred, density, near_density, params: SimParams):
    """Symmetric pressure + near-pressure force per particle (self excluded)."""
    delta, sq, dist = _pairwise(pred)
    h = params.smoothing_radius
    valid = (sq <= f32_mul(h, h)) & _not_self(pred.shape[0], pred.device)
    direction = pair_direction(delta, dist)
    pressure = K.density_to_pressure(density, params.target_density,
                                     params.pressure_multiplier)
    near_pressure = K.density_to_near_pressure(near_density, params.near_density_multiplier)
    pressure_term, near_term = pressure_pair_terms(
        pressure[:, None], pressure[None, :], near_pressure[:, None], near_pressure[None, :],
        density[:, None], density[None, :], near_density[None, :])
    dw = K.density_kernel_derivative(dist, h, params.density_kernel_norm)
    dwn = K.near_density_kernel_derivative(dist, h, params.near_density_kernel_norm)
    contrib = direction * (pressure_term * dw + near_term * dwn)[..., None]
    return torch.where(valid[..., None], contrib, 0.0).sum(1)


def all_pairs_viscosity(pred, vel, params: SimParams):
    """sum_j (v_j - v_i) W_visc(d) per particle (self excluded)."""
    _, sq, dist = _pairwise(pred)
    h = params.smoothing_radius
    valid = (sq <= f32_mul(h, h)) & _not_self(pred.shape[0], pred.device)
    w = torch.where(valid, K.viscosity_kernel(dist, h, params.viscosity_kernel_norm), 0.0)
    dv = vel[None, :, :] - vel[:, None, :]
    return (dv * w[..., None]).sum(1)


def _physics(state: ParticleState, params: SimParams) -> ParticleState:
    dt = params.dt
    vel, pred = gravity_predict(state, params)
    density, near_density = all_pairs_density(pred, params)
    f_p = all_pairs_pressure_force(pred, density, near_density, params)
    f_v = all_pairs_viscosity(pred, vel, params)  # pre-pressure velocities (spec v2)
    vel = vel + f_p * dt + f_v * params.viscosity_strength * dt
    return integrate(state, vel, params)


def reference_step(state: ParticleState, params: SimParams) -> ParticleState:
    """One bulk-synchronous SPH frame, honouring the shader warm-up delay."""
    stepped = _physics(state, params) if state.frame >= params.shader_delay else state
    return dataclasses.replace(stepped, frame=state.frame + 1)
