"""Carry state between the JAX package and the port, as numpy arrays.

The keys are the leaf names that the JAX ``runtime/checkpoint.save`` writes:
``state/px`` ... ``state/lost`` for a ``PlaneState`` (the SPH fluid),
``state/pos``, ``state/vel``, ``state/color``, ``state/frame`` (and
``state/ids`` where present) for a ``ParticleState`` (the other models), and
``params/<field>`` for ``SimParams``, ``NBodyParams``, ``FlowFieldParams`` (its
octave tables included) and ``AttractorParams``.  So a ``.npz`` saved by the
JAX package loads straight into the port, and :func:`save_npz` writes one the
JAX ``checkpoint.load`` reads back.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core.params import SimParams
from .core.state import ParticleState
from .models.attractor import AttractorParams
from .models.base import model_device
from .models.flow_field import FlowFieldParams
from .models.nbody import NBodyParams
from .ops.cuda.rebin import SENTINEL
from .ops.cuda.resident import ID_EXACT, PlaneState

PARAM_TYPES = (SimParams, NBodyParams, FlowFieldParams, AttractorParams)


def _field_value(v):
    """A numpy leaf as a params field: an int or float, or nested tuples."""
    v = np.asarray(v)
    return v.item() if v.ndim == 0 else tuple(_field_value(x) for x in v)


def params_from_numpy(arrays):
    """``params/<field>`` arrays -> the port's params of the type whose fields
    they name."""
    names = {k[len("params/"):] for k in arrays if k.startswith("params/")}
    for cls in PARAM_TYPES:
        fields = [f.name for f in dataclasses.fields(cls)]
        if set(fields) == names:
            return cls(**{f: _field_value(arrays[f"params/{f}"]) for f in fields})
    raise ValueError(f"no params type has the fields {sorted(names)}")


def params_to_numpy(params) -> dict:
    """Every field as a ``params/<field>`` array: int32 for integers (the SPH
    ``shader_delay``), float32 for the rest."""
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f"params/{f.name}"] = np.asarray(v, np.int32 if isinstance(v, int) else np.float32)
    return out


def plane_state_from_numpy(arrays, device="cuda") -> PlaneState:
    """``state/<field>`` arrays -> the port's PlaneState on ``device`` (the
    card unless the caller asks for the CPU).  ``n`` is not stored by the JAX
    checkpoint; it is the live count plus ``lost``."""
    device = model_device(device, "plane_state_from_numpy")
    planes = {k: torch.as_tensor(np.array(arrays[f"state/{k}"], np.float32),
                                 device=device).contiguous()
              for k in ("px", "py", "vx", "vy", "idsf")}
    lost = int(np.asarray(arrays["state/lost"]))
    live = int((planes["px"] < 0.5 * SENTINEL).sum())
    return PlaneState(**planes, frame=int(np.asarray(arrays["state/frame"])),
                      lost=torch.tensor(lost, dtype=torch.int32, device=device),
                      n=live + lost)


def particle_state_from_numpy(arrays, device="cuda") -> ParticleState:
    """``state/pos`` ... ``state/frame`` (and ``state/ids``) -> a ParticleState
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = model_device(device, "particle_state_from_numpy")
    t = {k: torch.as_tensor(np.array(arrays[f"state/{k}"], np.float32), device=device)
         for k in ("pos", "vel", "color")}
    ids = arrays.get("state/ids")
    if ids is not None:
        ids = torch.as_tensor(np.array(ids, np.int32), device=device)
    return ParticleState(**t, frame=int(np.asarray(arrays["state/frame"])), ids=ids)


def state_to_numpy(state) -> dict:
    """A PlaneState or ParticleState as the JAX checkpoint's ``state/`` leaves.
    The JAX package reads ``idsf`` as f32 values, exact to 2^24: a PlaneState
    of more particles raises ValueError."""
    if isinstance(state, PlaneState):
        if state.n > ID_EXACT:
            raise ValueError(f"a PlaneState of {state.n} particles: the JAX checkpoint "
                             f"holds ids as f32 values, exact only to 2^24")
        out = {f"state/{k}": getattr(state, k).detach().cpu().numpy()
               for k in ("px", "py", "vx", "vy", "idsf")}
        out["state/lost"] = np.asarray(int(state.lost), np.int32)
    else:
        out = {f"state/{k}": getattr(state, k).detach().cpu().numpy()
               for k in ("pos", "vel", "color")}
        if state.ids is not None:
            out["state/ids"] = state.ids.detach().cpu().numpy().astype(np.int32)
    out["state/frame"] = np.asarray(state.frame, np.int32)
    return out


def load_npz(path: str, device="cuda"):
    """(state, params or None) from a checkpoint written by either package: a
    PlaneState if it holds planes, else a ParticleState, on ``device`` (the
    card unless the caller asks for the CPU)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    from_numpy = plane_state_from_numpy if "state/px" in arrays else particle_state_from_numpy
    state = from_numpy(arrays, device)
    has_params = any(k.startswith("params/") for k in arrays)
    return state, (params_from_numpy(arrays) if has_params else None)


def save_npz(path: str, state, params=None) -> None:
    """Write the JAX checkpoint layout (atomic replace)."""
    payload = state_to_numpy(state)
    if params is not None:
        payload.update(params_to_numpy(params))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
