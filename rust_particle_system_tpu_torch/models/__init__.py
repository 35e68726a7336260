from .attractor import Attractor, AttractorParams, attractor_step, make_attractor_params
from .flow_field import FlowField, FlowFieldParams, flow_step, make_flow_params
from .nbody import NBody, NBodyParams, make_nbody_params, nbody_accel, nbody_step
from .sph import SPHFluid

MODEL_FAMILIES = {
    "sph": SPHFluid,
    "attractor": Attractor,
    "flow": FlowField,
    "nbody": NBody,
}

__all__ = [
    "SPHFluid",
    "Attractor",
    "AttractorParams",
    "attractor_step",
    "make_attractor_params",
    "FlowField",
    "FlowFieldParams",
    "flow_step",
    "make_flow_params",
    "NBody",
    "NBodyParams",
    "make_nbody_params",
    "nbody_accel",
    "nbody_step",
    "MODEL_FAMILIES",
]
