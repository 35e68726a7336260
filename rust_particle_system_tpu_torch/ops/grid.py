"""Spatial uniform grid: dense cell keys, one stable sort, run starts.

Counterpart of ``rust_particle_system_tpu/ops/grid.py``.  ``GridSpec`` is a copy
of the JAX frozen dataclass (so that nothing here imports jax); ``build_grid``
reproduces the JAX ``perm``, ``starts``, ``slot`` and ``overflow`` exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


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


class Grid(NamedTuple):
    """Per-frame neighbor structure over a sorted particle layout (no slot table:
    the plane build reads ``starts`` directly)."""

    perm: torch.Tensor  # [n] int32, sorted -> original
    sorted_keys: torch.Tensor  # [n] int32
    starts: torch.Tensor  # [num_cells + 1] int32 run starts
    slot: torch.Tensor  # [n] int32, slot of each sorted particle within its cell
    overflow: torch.Tensor  # [] int32, particles beyond capacity


def build_grid(spec: GridSpec, pos: torch.Tensor) -> Grid:
    """Bin + stable sort + run starts (the JAX ``build_grid`` with
    ``with_table=False``)."""
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
    counts = starts_full[1:] - starts_full[:-1]
    overflow = (counts - spec.capacity).clamp_min(0).sum().to(torch.int32)
    return Grid(
        perm=perm.to(torch.int32),
        sorted_keys=sorted_keys,
        starts=starts_full[: spec.num_cells + 1],
        slot=iota - run_start,
        overflow=overflow,
    )
