"""Carry state between the JAX package and the port, as numpy arrays.

The keys are the leaf names that the JAX ``runtime/checkpoint.save`` writes for a
``PlaneState`` and its ``SimParams`` (``state/px`` ... ``state/lost``,
``params/gravity`` ... ``params/bounds``), so a ``.npz`` saved by the JAX
package loads straight into the port, and :func:`save_npz` writes one the JAX
``checkpoint.load`` reads back.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core.params import SimParams
from .ops.cuda.rebin import SENTINEL
from .ops.cuda.resident import PlaneState

STATE_KEYS = ("px", "py", "vx", "vy", "idsf", "frame", "lost")
PARAM_KEYS = tuple(f.name for f in dataclasses.fields(SimParams))


def params_from_numpy(arrays) -> SimParams:
    """``params/<field>`` arrays -> the port's SimParams."""
    kw = {}
    for name in PARAM_KEYS:
        v = np.asarray(arrays[f"params/{name}"])
        kw[name] = tuple(float(b) for b in v) if name == "bounds" else v.item()
    return SimParams(**kw)


def params_to_numpy(params: SimParams) -> dict:
    out = {}
    for name in PARAM_KEYS:
        v = getattr(params, name)
        if name == "bounds":
            out[f"params/{name}"] = np.asarray(v, np.float32)
        elif name == "shader_delay":
            out[f"params/{name}"] = np.asarray(v, np.int32)
        else:
            out[f"params/{name}"] = np.asarray(v, np.float32)
    return out


def plane_state_from_numpy(arrays, device="cpu") -> PlaneState:
    """``state/<field>`` arrays -> the port's PlaneState on ``device``.  ``n`` is
    not stored by the JAX checkpoint; it is the live count plus ``lost``."""
    planes = {k: torch.as_tensor(np.array(arrays[f"state/{k}"], np.float32),
                                 device=device).contiguous()
              for k in ("px", "py", "vx", "vy", "idsf")}
    lost = int(np.asarray(arrays["state/lost"]))
    live = int((planes["px"] < 0.5 * SENTINEL).sum())
    return PlaneState(**planes, frame=int(np.asarray(arrays["state/frame"])),
                      lost=torch.tensor(lost, dtype=torch.int32, device=device),
                      n=live + lost)


def plane_state_to_numpy(ps: PlaneState) -> dict:
    out = {f"state/{k}": getattr(ps, k).detach().cpu().numpy()
           for k in ("px", "py", "vx", "vy", "idsf")}
    out["state/frame"] = np.asarray(ps.frame, np.int32)
    out["state/lost"] = np.asarray(int(ps.lost), np.int32)
    return out


def load_npz(path: str, device="cpu"):
    """(PlaneState, SimParams or None) from a checkpoint written by either
    package."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    state = plane_state_from_numpy(arrays, device)
    has_params = any(k.startswith("params/") for k in arrays)
    return state, (params_from_numpy(arrays) if has_params else None)


def save_npz(path: str, state: PlaneState, params: SimParams | None = None) -> None:
    """Write the JAX checkpoint layout (atomic replace)."""
    payload = plane_state_to_numpy(state)
    if params is not None:
        payload.update(params_to_numpy(params))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
