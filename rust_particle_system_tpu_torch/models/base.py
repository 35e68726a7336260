"""Model protocol: every model family exposes init / step / render.

Counterpart of ``rust_particle_system_tpu/models/base.py``.  A model bundles
static geometry with step functions over (state, params); the runtime driver
(``runtime/simulation.py``) loops any of them on the host.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch


class Model(Protocol):
    """Structural interface implemented by each model family."""

    def init(self, generator: torch.Generator, n: int) -> Any: ...

    def step(self, state: Any, params: Any) -> Any: ...

    def render(self, state: Any, params: Any, camera=None): ...

    def default_params(self) -> Any: ...
