"""Simulation parameters: a frozen dataclass of Python floats.

Counterpart of ``rust_particle_system_tpu/core/params.py``.  JAX threads the
parameters through ``jit`` as traced f32 scalars; here they are plain Python
values that the kernels take by value, so changing one never recompiles and the
frame loop never reads a value back from the device.

Every float is rounded to float32 on construction, so the scalar a kernel
receives is bit-for-bit the f32 scalar the JAX package computes with.  Derived
scalars (``gravity * dt``, the viscosity scale) are likewise formed in f32 by
:func:`f32_mul`, as JAX forms them.

Kernel normalisation constants follow the reference (`src/main.rs:96-98`):

    density_kernel_norm      = 10 / (pi * h^5)
    near_density_kernel_norm = 15 / (pi * h^6)
    viscosity_kernel_norm    =  4 / (pi * h^8)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Defaults mirroring the reference's compile-time constants (src/main.rs:25-35).
PARTICLE_COUNT = 50_000
PARTICLE_SIZE = 3.0
SMOOTHING_RADIUS = PARTICLE_SIZE * PARTICLE_SIZE  # 9.0 (src/main.rs:27)
GRAVITY = 0.0
TARGET_DENSITY = 0.011
PRESSURE_MULTIPLIER = 10_000.0
NEAR_DENSITY_MULTIPLIER = 1_000.0
VISCOSITY_STRENGTH = 5.0
DAMPING_FACTOR = 0.1
FIXED_DELTA_TIME = 1.0 / 100.0
MAX_ENERGY = 2_000.0

# A 1920x1080 viewport centred on the origin: [x_min, x_max, y_min, y_max].
DEFAULT_BOUNDS = (-960.0, 960.0, -540.0, 540.0)

# Both sim kernels no-op for the first SHADER_DELAY frames
# (assets/compute_shader.wgsl:66,426,442).
SHADER_DELAY = 5


def f32(v) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def f32_mul(a: float, b: float) -> float:
    """The float32 product of two float32 values (what a traced JAX scalar holds)."""
    return float(np.float32(a) * np.float32(b))


def _f32_tree(v):
    return tuple(_f32_tree(x) for x in v) if isinstance(v, (tuple, list)) else f32(v)


class F32Params:
    """Base of the models' frozen parameter dataclasses: fields annotated
    ``int`` hold ints, every other field a float32 scalar or a tuple (of
    tuples) of them, rounded on construction, as JAX holds them."""

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            object.__setattr__(self, f.name,
                               int(v) if f.type in (int, "int") else _f32_tree(v))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class SimParams(F32Params):
    """All simulation scalars; field names match the JAX ``SimParams``."""

    particle_size: float
    smoothing_radius: float
    max_energy: float
    damping_factor: float
    dt: float
    gravity: float
    density_kernel_norm: float
    near_density_kernel_norm: float
    viscosity_kernel_norm: float
    target_density: float
    pressure_multiplier: float
    viscosity_strength: float
    near_density_multiplier: float
    bounds: tuple  # (x_min, x_max, y_min, y_max)
    shader_delay: int

    def __post_init__(self):
        super().__post_init__()
        if len(self.bounds) != 4:
            raise ValueError("bounds must be (x_min, x_max, y_min, y_max)")


def kernel_norms(smoothing_radius: float) -> tuple[float, float, float]:
    """Host-side kernel normalisation constants (src/parameter_gui.rs:89-91)."""
    h = float(smoothing_radius)
    return (
        f32(10.0 / (math.pi * h**5)),
        f32(15.0 / (math.pi * h**6)),
        f32(4.0 / (math.pi * h**8)),
    )


def make_params(
    *,
    particle_size: float = PARTICLE_SIZE,
    smoothing_radius: float = SMOOTHING_RADIUS,
    max_energy: float = MAX_ENERGY,
    damping_factor: float = DAMPING_FACTOR,
    dt: float = FIXED_DELTA_TIME,
    gravity: float = GRAVITY,
    target_density: float = TARGET_DENSITY,
    pressure_multiplier: float = PRESSURE_MULTIPLIER,
    viscosity_strength: float = VISCOSITY_STRENGTH,
    near_density_multiplier: float = NEAR_DENSITY_MULTIPLIER,
    bounds: tuple = DEFAULT_BOUNDS,
    shader_delay: int = SHADER_DELAY,
) -> SimParams:
    """Build a SimParams, computing the radius-derived kernel norms host-side."""
    dn, nn, vn = kernel_norms(smoothing_radius)
    return SimParams(
        particle_size=particle_size,
        smoothing_radius=smoothing_radius,
        max_energy=max_energy,
        damping_factor=damping_factor,
        dt=dt,
        gravity=gravity,
        density_kernel_norm=dn,
        near_density_kernel_norm=nn,
        viscosity_kernel_norm=vn,
        target_density=target_density,
        pressure_multiplier=pressure_multiplier,
        viscosity_strength=viscosity_strength,
        near_density_multiplier=near_density_multiplier,
        bounds=tuple(bounds),
        shader_delay=shader_delay,
    )


def with_smoothing_radius(params: SimParams, smoothing_radius: float) -> SimParams:
    """Update the smoothing radius AND its derived kernel norms (GUI-slider analog,
    src/parameter_gui.rs:85-99)."""
    dn, nn, vn = kernel_norms(float(smoothing_radius))
    return params.replace(
        smoothing_radius=smoothing_radius,
        density_kernel_norm=dn,
        near_density_kernel_norm=nn,
        viscosity_kernel_norm=vn,
    )
