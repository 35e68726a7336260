"""rust_particle_system_tpu_torch — the particle models on PyTorch and hand-written CUDA.

A port of the JAX package ``rust_particle_system_tpu`` (the reference, which
stays beside it) to one NVIDIA H100.  It imports torch and never jax.  The
layout mirrors the JAX package, so each module's counterpart has the same name:

    core/      params dataclass, SoA particle state, SPH kernel math
    ops/       grid build (slot table), the grid step and the all-pairs
               oracle step; ops/cuda/ holds the wrappers of the CUDA kernels
               (csrc/*.cu), each beside its plain PyTorch version
    models/    the SPH fluid (plane-resident state, classic or pair-packed
               layout; or the grid and oracle backends), the N-body, the
               flow field and the attractor
    render/    the general splat, the cell-binned splat and the plane
               rasterizer of the fused frame
    parallel/  the band-sharded mesh: one process per band of cell rows
               (torch.distributed), its halos, step and rendered frame
    runtime/   host-loop driver, validators, CLI
    utils/     the PNG writer
    interop    state and params to and from the JAX checkpoint layout
"""

import torch

from .core.params import SimParams, make_params
from .core.state import ParticleState, make_state, scatter_init

# PyTorch's CPU kernels of sqrt, sin and cos settle on their vector code at
# their first call in a process.  A first call that PyTorch splits over
# threads was seen to return values up to 2.5e-4 off on part of the tensor
# (torch 2.13, AVX-512), and only then; one call on one element first avoids
# it, so the plain versions give the same result on every call.
_one = torch.ones(1)
torch.sqrt(_one), torch.sin(_one), torch.cos(_one)
del _one

__version__ = "0.1.0"

__all__ = [
    "SimParams",
    "make_params",
    "ParticleState",
    "make_state",
    "scatter_init",
    "__version__",
]
