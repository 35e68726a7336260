"""Cell-plane build: cell-sorted particle rows -> ``[num_cells, C, k]`` slot planes.

Counterpart of ``rust_particle_system_tpu/ops/pallas/plane_build.py``.  Kernel
K5 (``csrc/plane_build.cu``) replaces the Pallas ``_make_roll_kernel`` driven by
``cell_planes_aos``.  It runs once, at init.

K5 is bound by data movement only (read the rows, write the planes).  The TPU
version fetched two aligned row windows per cell and rolled them into place with
a log-shift, because per-slot gathers are slow there; on the H100 one thread per
output word gathers its source directly, coalesced on both sides.
"""

from __future__ import annotations

import torch

from . import _lib


def cell_planes_aos_plain(sorted_packed: torch.Tensor, starts: torch.Tensor,
                          num_cells: int, capacity: int, fills) -> torch.Tensor:
    """Plain PyTorch version: slot s of cell c is row ``starts[c] + s`` while
    ``s < min(count_c, C)``, else the per-channel fill."""
    n, k = sorted_packed.shape
    dev = sorted_packed.device
    s0 = starts[:num_cells].long()
    counts = (starts[1: num_cells + 1].long() - s0).clamp_max(capacity)
    slot = torch.arange(capacity, device=dev)
    rows = (s0[:, None] + slot[None, :]).clamp(0, max(n - 1, 0))
    valid = slot[None, :] < counts[:, None]
    fill = torch.tensor(fills, dtype=torch.float32, device=dev)
    return torch.where(valid[..., None], sorted_packed[rows], fill)


_plane_build = _lib.kernel("rps_plane_build")


def cell_planes_aos(sorted_packed: torch.Tensor, starts: torch.Tensor,
                    num_cells: int, capacity: int, fills) -> torch.Tensor:
    """``[n, k]`` cell-sorted rows + ``[num_cells + 1]`` run starts ->
    ``[num_cells, capacity, k]`` planes.  Launches K5 for CUDA tensors; runs the
    plain version for CPU tensors."""
    if _lib.dispatch(sorted_packed) == "plain":
        return cell_planes_aos_plain(sorted_packed, starts, num_cells, capacity,
                                     fills)
    _lib.require_cuda_planes(sorted_packed)
    n, k = sorted_packed.shape
    starts = starts.to(torch.int32).contiguous()
    if starts.device != sorted_packed.device or starts.numel() < num_cells + 1:
        raise ValueError("starts must be [num_cells + 1] on the rows' device")
    if len(fills) != k:
        raise ValueError("one fill per channel")
    out = torch.empty(num_cells, capacity, k, dtype=torch.float32,
                      device=sorted_packed.device)
    _plane_build(sorted_packed.data_ptr(), starts.data_ptr(), out.data_ptr(),
                 *_lib.pad8([float(f) for f in fills]), k, num_cells, capacity)
    cell_planes_aos.launches += 1
    return out


cell_planes_aos.launches = 0
