"""Particles at rest, uniform over the configuration's bounds, as the JAX
bench's rows start them (``bench.py:401``, ``:553-558``): ``n`` positions
drawn from ``seed`` by a generator on ``device``, in one call."""

from __future__ import annotations

import torch


def particles(cfg: dict, seed: int, device):
    """``(pos [n, 2], vel [n, 2])``: the inputs both the port and the
    reference are handed."""
    x_min, x_max, y_min, y_max = (float(b) for b in cfg["bounds"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = int(cfg["n"])
    u = torch.rand((n, 2), generator=gen, device=device)
    lo = torch.tensor([x_min, y_min], device=device)
    hi = torch.tensor([x_max, y_max], device=device)
    return lo + u * (hi - lo), torch.zeros((n, 2), device=device)
