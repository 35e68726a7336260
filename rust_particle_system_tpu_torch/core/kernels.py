"""SPH smoothing-kernel math, pressure maps, bounce and colour ramp, on tensors.

Counterpart of ``rust_particle_system_tpu/core/kernels.py``; the same functional
re-statements of the WGSL helpers in ``assets/compute_shader.wgsl``:

* kernels + derivatives           (compute_shader.wgsl:145-188)
* density->pressure maps          (compute_shader.wgsl:191-199)
* boundary clamp + damped bounce  (compute_shader.wgsl:69-99)
* kinetic-energy colour ramp      (compute_shader.wgsl:101-118)
"""

from __future__ import annotations

import torch


def density_kernel(d, h, norm):
    """``norm * (h - d)^2`` inside the radius."""
    v = h - d
    return torch.where(d < h, norm * v * v, 0.0)


def density_kernel_derivative(d, h, norm):
    """``-2 * norm * (h - d)`` inside the radius."""
    v = h - d
    return torch.where(d < h, -2.0 * norm * v, 0.0)


def near_density_kernel(d, h, norm):
    """``norm * (h - d)^3`` inside the radius."""
    v = h - d
    return torch.where(d < h, norm * v * v * v, 0.0)


def near_density_kernel_derivative(d, h, norm):
    """``-3 * norm * (h - d)^2`` inside the radius."""
    v = h - d
    return torch.where(d < h, -3.0 * norm * v * v, 0.0)


def viscosity_kernel(d, h, norm):
    """``norm * (h^2 - d^2)^3`` inside the radius."""
    v = h * h - d * d
    return torch.where(d < h, norm * v * v * v, 0.0)


def density_to_pressure(density, target_density, pressure_multiplier):
    return (density - target_density) * pressure_multiplier


def density_to_near_pressure(near_density, near_density_multiplier):
    return near_density * near_density_multiplier


def bounce_axis(x, v, lo: float, hi: float, damping: float):
    """One axis of check_screen_bounds: at/below ``lo`` the velocity is forced
    inward via ``abs`` and damped (even if it already pointed inward), symmetric at
    ``hi``; the position is clamped."""
    v = torch.where(x <= lo, v.abs() * damping, v)
    v = torch.where(x >= hi, -v.abs() * damping, v)
    return x.clamp(lo, hi), v


def bounce_bounds(pos, vel, bounds, damping_factor: float):
    """Clamp ``[..., 2]`` positions to ``bounds`` and reflect+damp the velocity;
    only the violating axis is damped (compute_shader.wgsl:80-95)."""
    x_min, x_max, y_min, y_max = bounds
    x, vx = bounce_axis(pos[..., 0], vel[..., 0], x_min, x_max, damping_factor)
    y, vy = bounce_axis(pos[..., 1], vel[..., 1], y_min, y_max, damping_factor)
    return torch.stack([x, y], dim=-1), torch.stack([vx, vy], dim=-1)


def energy_color(vel, max_energy: float):
    """Blue->green->red ramp on kinetic energy ``0.5 * |v|^2`` (unit mass), alpha 1.
    The energy is divided by ``max_energy`` held in a tensor on its device
    (a fill, no copy from the host), so the division is a true one on the
    card too, as the JAX package and kernel K4 divide: PyTorch on CUDA turns
    a division by a host scalar into a multiply by its reciprocal, which
    rounds differently."""
    speed_sq = (vel * vel).sum(dim=-1)
    divisor = torch.full((), float(max_energy), dtype=speed_sq.dtype, device=speed_sq.device)
    t = (0.5 * speed_sq / divisor).clamp(0.0, 1.0)
    lo = t * 2.0
    hi = (t - 0.5) * 2.0
    low = t < 0.5
    r = torch.where(low, 0.0, hi)
    g = torch.where(low, lo, 1.0 - hi)
    b = torch.where(low, 1.0 - lo, 0.0)
    return torch.stack([r, g, b, torch.ones_like(r)], dim=-1)
