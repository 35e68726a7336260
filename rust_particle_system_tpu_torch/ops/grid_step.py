"""Grid-accelerated SPH step in plain PyTorch: O(n k), held to the oracle.

Counterpart of ``rust_particle_system_tpu/ops/grid_step.py``.  After a sort
into cell order, every cell's <= C particles meet the <= 9C particles of its
3x3 neighbourhood as one ``[C, 9C]`` pairwise tile, evaluated for a chunk of
B cells at a time (``[B, C, 9C]`` temporaries) in three passes: density,
pressure, viscosity.  The grid is built from the predicted positions, as the
oracle (``reference_step.py``) measures distances; particles beyond a cell's
capacity are counted in ``Grid.overflow`` and exert and receive no pair force
that frame.

Each row of a tile sums on its own, so the chunk size changes no result.  The
JAX package maps chunks of 256 cells; here a chunk takes as many cells as fit
``PAIR_BUDGET`` pair elements (64 MB per float32 temporary, about a dozen
temporaries live in the pressure pass): at the 50k default grid (capacity 31)
that is 1,940 cells, 14 chunks per pass, where 256 would issue about 100.
No CUDA kernel: the JAX version has no Pallas either.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import kernels as K
from ..core.params import SimParams, f32_mul
from ..core.state import ParticleState
from .grid import GridSpec, build_grid, gather_to_cells
from .reference_step import (gravity_predict, integrate, pair_direction,
                             pressure_pair_terms, safe_dist)

PAIR_BUDGET = 1 << 24  # pair elements per chunk of cells


class CellChunk(NamedTuple):
    """A chunk's gathered cells, fed to the pairwise passes."""

    own_pos: torch.Tensor  # [B, C, 2]
    own_idx: torch.Tensor  # [B, C] sorted index, -1 = empty
    nbr_pos: torch.Tensor  # [B, 9C, 2]
    nbr_idx: torch.Tensor  # [B, 9C] sorted index, -1 = empty


def pair_geometry(chunk: CellChunk, h: float):
    """Pairwise (delta, distance, valid) of a chunk: [B, C, 9C]."""
    delta = chunk.nbr_pos[:, None, :, :] - chunk.own_pos[:, :, None, :]  # x_j - x_i
    sq = (delta * delta).sum(-1)
    valid = ((chunk.own_idx[:, :, None] >= 0) & (chunk.nbr_idx[:, None, :] >= 0)
             & (sq <= f32_mul(h, h)))
    return delta, safe_dist(sq), valid


def _not_self(chunk: CellChunk):
    return chunk.own_idx[:, :, None] != chunk.nbr_idx[:, None, :]


def density_pass(chunk: CellChunk, params: SimParams):
    h = params.smoothing_radius
    _, dist, valid = pair_geometry(chunk, h)
    w = torch.where(valid, K.density_kernel(dist, h, params.density_kernel_norm), 0.0)
    wn = torch.where(valid, K.near_density_kernel(dist, h, params.near_density_kernel_norm),
                     0.0)
    return w.sum(-1), wn.sum(-1)  # [B, C] each


def pressure_pass(chunk: CellChunk, own_rho, own_rhon, nbr_rho, nbr_rhon, params: SimParams):
    """[B, C, 2] pressure + near-pressure force; self excluded by sorted index."""
    h = params.smoothing_radius
    delta, dist, valid = pair_geometry(chunk, h)
    valid = valid & _not_self(chunk)
    direction = pair_direction(delta, dist)
    pres = lambda rho: K.density_to_pressure(rho, params.target_density,
                                             params.pressure_multiplier)
    near = lambda rhon: K.density_to_near_pressure(rhon, params.near_density_multiplier)
    # Padded slots (rho = 0) are guarded before dividing; 'valid' masks them after.
    pressure_term, near_term = pressure_pair_terms(
        pres(own_rho)[:, :, None], pres(nbr_rho)[:, None, :],
        near(own_rhon)[:, :, None], near(nbr_rhon)[:, None, :],
        torch.where(own_rho > 0, own_rho, 1.0)[:, :, None],
        torch.where(nbr_rho > 0, nbr_rho, 1.0)[:, None, :],
        torch.where(nbr_rhon > 0, nbr_rhon, 1.0)[:, None, :])
    dw = K.density_kernel_derivative(dist, h, params.density_kernel_norm)
    dwn = K.near_density_kernel_derivative(dist, h, params.near_density_kernel_norm)
    contrib = direction * (pressure_term * dw + near_term * dwn)[..., None]
    return torch.where(valid[..., None], contrib, 0.0).sum(2)


def viscosity_pass(chunk: CellChunk, own_vel, nbr_vel, params: SimParams):
    """[B, C, 2] viscosity force sum (v_j - v_i) W_visc."""
    h = params.smoothing_radius
    _, dist, valid = pair_geometry(chunk, h)
    valid = valid & _not_self(chunk)
    w = torch.where(valid, K.viscosity_kernel(dist, h, params.viscosity_kernel_norm), 0.0)
    dv = nbr_vel[:, None, :, :] - own_vel[:, :, None, :]
    return (dv * w[..., None]).sum(2)


def chunk_size(spec: GridSpec) -> int:
    """Cells per chunk: as many as fit ``PAIR_BUDGET``."""
    return max(1, PAIR_BUDGET // (9 * spec.capacity * spec.capacity))


def grid_physics(state: ParticleState, params: SimParams, spec: GridSpec):
    """One physics frame through the spatial grid.  Returns
    (new state, overflow)."""
    dt = params.dt
    vel, pred = gravity_predict(state, params)
    grid = build_grid(spec, pred)
    nc, C = spec.num_cells, spec.capacity
    perm = grid.perm.long()
    pred_s, vel_s = pred[perm], vel[perm]

    # Cell-dense layout (+1 padding row for out-of-grid neighbour lookups).
    nids = spec.neighbor_cell_ids(pred.device).long()  # [nc, 9]
    cpos = gather_to_cells(grid, spec, pred_s)  # [nc + 1, C, 2]
    own = (cpos[:nc], grid.table[:nc],
           cpos[nids].reshape(nc, 9 * C, 2), grid.table[nids].reshape(nc, 9 * C))
    B = chunk_size(spec)

    def run_pass(fn, *extras):
        """Map a pairwise pass over chunks of cells; ``extras`` are per-cell
        arrays cut alike."""
        outs = [fn(CellChunk(*(a[c0:c0 + B] for a in own)), *(e[c0:c0 + B] for e in extras))
                for c0 in range(0, nc, B)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    rho, rhon = run_pass(lambda c: density_pass(c, params))
    pad = torch.zeros((1, C), dtype=rho.dtype, device=rho.device)
    nbr_rho = torch.cat([rho, pad])[nids].reshape(nc, 9 * C)
    nbr_rhon = torch.cat([rhon, pad])[nids].reshape(nc, 9 * C)
    f_p = run_pass(lambda c, *a: pressure_pass(c, *a, params), rho, rhon, nbr_rho, nbr_rhon)
    # Viscosity over the PRE-pressure velocities (spec v2, reference_step.py).
    cvel = gather_to_cells(grid, spec, vel_s)
    f_v = run_pass(lambda c, *a: viscosity_pass(c, *a, params), cvel[:nc],
                   cvel[nids].reshape(nc, 9 * C, 2))

    def cells_to_sorted(cell_vals):
        """[nc, C, 2] per-slot values back to sorted rows; overflow rows get 0."""
        slot = grid.slot.clamp_max(C - 1).long()
        vals = cell_vals[grid.sorted_keys.long(), slot]
        return torch.where((grid.slot < C)[:, None], vals, 0.0)

    vel_s = (vel_s + cells_to_sorted(f_p) * dt
             + cells_to_sorted(f_v) * params.viscosity_strength * dt)
    # Un-sort through the inverse permutation (the JAX argsort(perm)).
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return integrate(state, vel_s[inv], params), grid.overflow


def grid_step(state: ParticleState, params: SimParams, spec: GridSpec) -> ParticleState:
    """One frame (warm-up honouring), grid-accelerated: a drop-in for
    ``reference_step``."""
    if state.frame >= params.shader_delay:
        stepped = grid_physics(state, params, spec)[0]
    else:
        stepped = state
    return dataclasses.replace(stepped, frame=state.frame + 1)
