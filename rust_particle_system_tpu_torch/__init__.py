"""rust_particle_system_tpu_torch — the SPH fluid on PyTorch and hand-written CUDA.

A port of the JAX package ``rust_particle_system_tpu`` (the reference, which
stays beside it) to one NVIDIA H100.  It imports torch and never jax.  The
layout mirrors the JAX package, so each module's counterpart has the same name:

    core/      params dataclass, SoA particle state, SPH kernel math
    ops/       grid build; ops/cuda/ holds the wrappers of the CUDA kernels
               (csrc/*.cu), each beside its plain PyTorch version
    models/    the SPH fluid (plane-resident state)
    render/    the general splat and the plane rasterizer of the fused frame
    runtime/   host-loop driver, validators, CLI
    utils/     the PNG writer
    interop    state and params to and from the JAX checkpoint layout
"""

from .core.params import SimParams, make_params
from .core.state import ParticleState, make_state, scatter_init

__version__ = "0.1.0"

__all__ = [
    "SimParams",
    "make_params",
    "ParticleState",
    "make_state",
    "scatter_init",
    "__version__",
]
