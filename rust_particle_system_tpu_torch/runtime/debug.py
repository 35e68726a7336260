"""State validators: raise on violated invariants.

Counterpart of ``rust_particle_system_tpu/runtime/debug.py::validate_state``.
"""

from __future__ import annotations

import numpy as np

from ..core.params import SimParams
from ..core.state import ParticleState


def _require(cond: bool, message: str) -> None:
    """Explicit raise (not ``assert``): these checks back ``Simulation.stats()``
    and the CLI's ``--stats``, which must survive ``python -O``."""
    if not cond:
        raise ValueError(message)


def validate_state(state: ParticleState, params: SimParams) -> dict:
    """Invariant check on a state: finite, inside bounds.  Raises ValueError."""
    pos = state.pos.detach().cpu().numpy()
    vel = state.vel.detach().cpu().numpy()
    b = params.bounds
    _require(bool(np.all(np.isfinite(pos))), "non-finite positions")
    _require(bool(np.all(np.isfinite(vel))), "non-finite velocities")
    if pos.shape[0]:
        _require(bool(pos[:, 0].min() >= b[0] - 1e-4 and pos[:, 0].max() <= b[1] + 1e-4),
                 "positions outside x bounds")
        _require(bool(pos[:, 1].min() >= b[2] - 1e-4 and pos[:, 1].max() <= b[3] + 1e-4),
                 "positions outside y bounds")
    speed = np.linalg.norm(vel, axis=1)
    return {
        "n": pos.shape[0],
        "frame": int(state.frame),
        "speed_mean": float(speed.mean()) if speed.size else 0.0,
        "speed_max": float(speed.max()) if speed.size else 0.0,
        "kinetic_energy_mean": float(0.5 * (speed**2).mean()) if speed.size else 0.0,
    }
