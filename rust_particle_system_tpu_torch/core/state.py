"""Particle state: structure-of-arrays tensors.

Counterpart of ``rust_particle_system_tpu/core/state.py``.  ``frame`` is a
host-side Python int (the reference bumps ``Config.frame_count`` host-side every
frame, `src/particle_buffers.rs:228`), so the warm-up gate costs no device read.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state: ``pos``/``vel`` ``[n, 2]``, ``color`` ``[n, 4]`` f32.

    ``ids`` (optional ``[n]`` int32) is each row's original particle index, for
    states whose rows are not in original order."""

    pos: torch.Tensor
    vel: torch.Tensor
    color: torch.Tensor
    frame: int = 0
    ids: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def with_ids(self) -> "ParticleState":
        """Attach identity tracking (a fresh 0..n-1 ids column) if absent."""
        if self.ids is not None:
            return self
        ids = torch.arange(self.n, dtype=torch.int32, device=self.pos.device)
        return dataclasses.replace(self, ids=ids)


def make_state(pos, vel=None, color=None, frame: int = 0,
               device=None) -> ParticleState:
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    n = pos.shape[0]
    if vel is None:
        vel = torch.zeros((n, 2), dtype=torch.float32, device=pos.device)
    if color is None:
        # Initial particles are white (src/main.rs:210).
        color = torch.ones((n, 4), dtype=torch.float32, device=pos.device)
    return ParticleState(
        pos=pos,
        vel=torch.as_tensor(vel, dtype=torch.float32, device=pos.device),
        color=torch.as_tensor(color, dtype=torch.float32, device=pos.device),
        frame=int(frame),
    )


def scatter_init(generator: torch.Generator, n: int, bounds,
                 y_std_frac: float = 0.125) -> ParticleState:
    """One-shot particle scatter matching the reference initializer
    (src/main.rs:182-216), on ``generator``'s device.

    x is spread uniformly across the width (``x_i = x_min + (i/n)(x_max-x_min)``,
    src/main.rs:200-201); y is drawn from ``Normal(y_center, 0.125 * height)`` and
    clamped to the bounds; velocity is zero and colour white.  torch and JAX draw
    different normals from the same seed."""
    device = generator.device
    x_min, x_max, y_min, y_max = [float(b) for b in bounds]
    i = torch.arange(n, dtype=torch.float32, device=device)
    x = x_min + (i / n) * (x_max - x_min)
    y_center = (y_min + y_max) / 2.0
    y_std = (y_max - y_min) * y_std_frac
    y = y_center + y_std * torch.randn(n, generator=generator, device=device)
    y = y.clamp(y_min, y_max)
    return make_state(torch.stack([x, y], dim=-1))
