"""Validators and inspectors: raise on violated invariants.

Counterpart of ``rust_particle_system_tpu/runtime/debug.py``: the live
version of the reference's compiled-out debug node (`src/debug.rs`).  Each
reads its tensors back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.params import SimParams
from ..core.state import ParticleState
from ..ops.grid import Grid, GridSpec, build_grid
from ..ops.grid_step import grid_physics


def _require(cond: bool, message: str) -> None:
    """Explicit raise (not ``assert``): these checks back ``Simulation.stats()``
    and the CLI's ``--stats``, which must survive ``python -O``."""
    if not cond:
        raise ValueError(message)


def validate_grid(grid: Grid, spec: GridSpec, n: int) -> dict:
    """Check the neighbour structure's invariants (debug.rs:166-175 made
    strict): sorted keys, a permutation, monotone run starts, an empty padding
    row, front-packed slots.  Returns occupancy stats; raises ValueError."""
    sorted_keys = grid.sorted_keys.cpu().numpy()
    perm = grid.perm.cpu().numpy()
    starts = grid.starts.cpu().numpy()
    table = grid.table.cpu().numpy()
    _require(bool(np.all(np.diff(sorted_keys) >= 0)), "spatial lookup not sorted")
    _require(np.array_equal(np.sort(perm), np.arange(n)), "perm is not a permutation")
    _require(bool(np.all(starts[:-1] <= starts[1:])), "run starts not monotone")
    _require(table.shape == (spec.num_cells + 1, spec.capacity), "no slot table")
    _require(bool(np.all(table[-1] == -1)), "padding row not empty")
    live = table >= 0
    counts = live.sum(axis=1)[:-1]
    # front-packed: within every row, no live slot may follow an empty one
    _require(bool(np.all(live[:, 1:] <= live[:, :-1])), "slots not packed front-first")
    return {
        "cells_used": int((counts > 0).sum()),
        "max_occupancy": int(counts.max()) if counts.size else 0,
        "mean_occupancy": float(counts[counts > 0].mean()) if (counts > 0).any() else 0.0,
        "overflow": int(grid.overflow),
    }


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


def density_report(state: ParticleState, params: SimParams, spec: GridSpec) -> dict:
    """Grid statistics of the current state, plus the overflow of one grid
    physics frame from it (debug.rs:267-287 analog)."""
    _, overflow = grid_physics(state, params, spec)
    stats = validate_grid(build_grid(spec, state.pos), spec, state.n)
    stats["step_overflow"] = int(overflow)
    return stats


def print_config(params) -> str:
    """Human-readable parameter dump (debug.rs:96-119 analog), each field as
    the JAX package holds it (int32 or float32).  Prints and returns the text."""
    lines = [f"{type(params).__name__}:"]
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        val = np.asarray(v, np.int32 if isinstance(v, int) else np.float32)
        lines.append(f"  {f.name:26s} = {np.array2string(val, precision=6)}")
    text = "\n".join(lines)
    print(text)
    return text
