from . import kernels
from .params import SimParams, kernel_norms, make_params, with_smoothing_radius
from .state import ParticleState, make_state, scatter_init

__all__ = [
    "SimParams",
    "make_params",
    "with_smoothing_radius",
    "kernel_norms",
    "ParticleState",
    "make_state",
    "scatter_init",
    "kernels",
]
