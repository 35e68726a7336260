"""Spatial uniform grid: dense cell keys, one stable sort, run starts.

Counterpart of ``rust_particle_system_tpu/ops/grid.py``.  ``GridSpec`` is a copy
of the JAX frozen dataclass (so that nothing here imports jax); ``build_grid``
reproduces the JAX ``perm``, ``sorted_keys``, ``starts``, ``slot``,
``overflow`` and slot ``table`` exactly.  The table and
:func:`gather_to_cells` feed the sort-binned path: the grid SPH step
(``grid_step.py``), the grid validator and the cell-binned splat (K11); the
plane-resident path reads ``starts`` only and skips the table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

# 3x3 neighbourhood, matching GRID_OFFSETS (compute_shader.wgsl:201-205).
NEIGHBOR_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


def cell_index(v: torch.Tensor, lo: float, width: float, n: int) -> torch.Tensor:
    """``clip(int(floor((v - lo) / width)), 0, n - 1)`` in IEEE float32.

    The one keying helper of the port: the grid build, the rebin's plain version
    and the defer mask all go through it, and the CUDA kernels evaluate the same
    expression.  The divisor is a device tensor on purpose: PyTorch on CUDA
    divides by a host scalar as a multiply by its reciprocal, which can move a
    particle across a cell edge."""
    w = torch.full((), width, dtype=torch.float32, device=v.device)
    k = torch.floor((v - lo) / w).to(torch.int32)
    return k.clamp(0, n - 1)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (see the JAX ``GridSpec``)."""

    x_min: float
    y_min: float
    cell_size: float  # cell height (y extent); also the x extent when cell_w == 0
    gw: int  # grid width in cells
    gh: int  # grid height in cells
    capacity: int  # max particles per cell
    cell_w: float = 0.0  # cell width; 0 means "== cell_size"
    pack2: bool = False  # pair-packed walk layout (kernel K6), capacity <= 64

    @property
    def cell_width(self) -> float:
        return self.cell_w if self.cell_w > 0.0 else self.cell_size

    @classmethod
    def from_bounds(cls, bounds, cell_size: float, capacity: int,
                    cell_aspect: int = 1, pack2: bool = False) -> "GridSpec":
        x_min, x_max, y_min, y_max = [float(b) for b in bounds]
        cell_w = cell_size * cell_aspect
        gw = int(math.floor((x_max - x_min) / cell_w)) + 1
        gh = int(math.floor((y_max - y_min) / cell_size)) + 1
        if pack2 and capacity > 64:
            raise ValueError("pack2 layout requires capacity <= 64")
        return cls(
            x_min=x_min,
            y_min=y_min,
            cell_size=float(cell_size),
            gw=gw,
            gh=gh,
            capacity=int(capacity),
            cell_w=float(cell_w) if cell_aspect != 1 else 0.0,
            pack2=bool(pack2),
        )

    @property
    def num_cells(self) -> int:
        return self.gw * self.gh

    def cell_coords(self, pos: torch.Tensor):
        """Integer cell coords of ``[..., 2]`` positions, clipped into the grid."""
        cx = cell_index(pos[..., 0], self.x_min, self.cell_width, self.gw)
        cy = cell_index(pos[..., 1], self.y_min, self.cell_size, self.gh)
        return cx, cy

    def cell_keys(self, pos: torch.Tensor) -> torch.Tensor:
        cx, cy = self.cell_coords(pos)
        return cy * self.gw + cx

    def neighbor_cell_ids(self, device=None) -> torch.Tensor:
        """[num_cells, 9] int32 neighbour cell ids in :data:`NEIGHBOR_OFFSETS`
        order; out-of-grid neighbours map to num_cells (the slot table's
        padding row)."""
        cid = torch.arange(self.num_cells, dtype=torch.int32, device=device)
        cx, cy = cid % self.gw, cid // self.gw
        ids = []
        for dx, dy in NEIGHBOR_OFFSETS:
            nx, ny = cx + dx, cy + dy
            valid = (nx >= 0) & (nx < self.gw) & (ny >= 0) & (ny < self.gh)
            ids.append(torch.where(valid, ny * self.gw + nx, self.num_cells))
        return torch.stack(ids, dim=1)


class Grid(NamedTuple):
    """Per-frame neighbour structure over a sorted particle layout.

    ``perm`` maps sorted row -> original particle index.  ``table[c, s]`` is the
    sorted-order index of the s-th particle of cell c, or -1 for an empty slot;
    its extra row num_cells is always empty (out-of-grid neighbour lookups)."""

    perm: torch.Tensor  # [n] int32, sorted -> original
    sorted_keys: torch.Tensor  # [n] int32
    starts: torch.Tensor  # [num_cells + 1] int32 run starts
    table: torch.Tensor  # [num_cells + 1, capacity] int32 (-1 empty), or [0, capacity]
    slot: torch.Tensor  # [n] int32, slot of each sorted particle within its cell
    overflow: torch.Tensor  # [] int32, particles beyond capacity


def build_grid(spec: GridSpec, pos: torch.Tensor, with_table: bool = True) -> Grid:
    """Bin + stable sort + run starts + slot table, as the JAX ``build_grid``.

    The table is derived arithmetically from the run starts,
    ``table[c, s] = starts[c] + s`` while ``s`` is inside the run, with no
    scatter.  ``with_table=False`` leaves it as a ``[0, capacity]``
    placeholder, for callers that read ``starts`` only (the plane build)."""
    n = pos.shape[0]
    dev = pos.device
    keys = spec.cell_keys(pos)
    sorted_keys, perm = torch.sort(keys, stable=True)
    # +2: row num_cells is the always-empty padding row (start == end == n there).
    cell_ids = torch.arange(spec.num_cells + 2, dtype=torch.int32, device=dev)
    starts_full = torch.searchsorted(sorted_keys, cell_ids, side="left").to(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    counts = starts_full[1:] - starts_full[:-1]  # [num_cells + 1]
    overflow = (counts - spec.capacity).clamp_min(0).sum().to(torch.int32)
    if with_table:
        sidx = torch.arange(spec.capacity, dtype=torch.int32, device=dev)[None, :]
        table = torch.where(sidx < counts[:, None], starts_full[:-1, None] + sidx, -1)
    else:
        table = torch.zeros((0, spec.capacity), dtype=torch.int32, device=dev)
    return Grid(
        perm=perm.to(torch.int32),
        sorted_keys=sorted_keys,
        starts=starts_full[: spec.num_cells + 1],
        table=table,
        slot=iota - run_start,
        overflow=overflow,
    )


def gather_to_cells(grid: Grid, spec: GridSpec, sorted_values: torch.Tensor) -> torch.Tensor:
    """[n, k] sorted-order values -> [num_cells + 1, capacity, k] cell-dense
    values; empty slots are zero (``grid.table >= 0`` is the validity mask)."""
    n = sorted_values.shape[0]
    pad = torch.zeros((1,) + tuple(sorted_values.shape[1:]), dtype=sorted_values.dtype,
                      device=sorted_values.device)
    padded = torch.cat([sorted_values, pad])
    idx = torch.where(grid.table >= 0, grid.table, n)
    return padded[idx.long()]


def suggest_capacity(n: int, spec_or_bounds, cell_size: float | None = None,
                     safety: float = 4.0) -> int:
    """Per-cell capacity heuristic: ``safety`` x the uniform mean occupancy,
    at least 8 (the JAX ``suggest_capacity``)."""
    if cell_size is None:
        num_cells = spec_or_bounds.num_cells
    else:
        x_min, x_max, y_min, y_max = [float(b) for b in spec_or_bounds]
        gw = int(math.floor((x_max - x_min) / cell_size)) + 1
        gh = int(math.floor((y_max - y_min) / cell_size)) + 1
        num_cells = gw * gh
    avg = n / max(num_cells, 1)
    return max(8, int(math.ceil(avg * safety)))
