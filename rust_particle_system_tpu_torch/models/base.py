"""Model protocol: every model family exposes init / step / render.

Counterpart of ``rust_particle_system_tpu/models/base.py``.  A model bundles
static geometry with step functions over (state, params); the runtime driver
(``runtime/simulation.py``) loops any of them on the host.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch


def model_device(device, caller: str) -> torch.device:
    """The device a model or a loader runs on: the card unless the caller asks
    for the CPU, with no silent fallback when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return device


class Model(Protocol):
    """Structural interface implemented by each model family."""

    def init(self, generator: torch.Generator, n: int) -> Any: ...

    def step(self, state: Any, params: Any) -> Any: ...

    def render(self, state: Any, params: Any, camera=None): ...

    def default_params(self) -> Any: ...
