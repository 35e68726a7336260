"""The plain reference of the rendered frame's image, in PyTorch alone.

A frozen copy of the port's plain plane render (its staging, the per-cell
patch accumulators, the fold into the image, the sum rule and the resolve over
a black background), imported from nothing of the port.  Each cell's live
slots draw a soft disc of the particle's radius, coloured by the kinetic
energy ramp, into a patch of the cell's pixels and a margin; the patches add
up, and the image is the coverage-weighted mean colour.  ``pair_dtype``
computes the (sprite, pixel) terms in another type (bfloat16: the control).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .sph import SENTINEL, Grid, Params, live

FAR = SENTINEL
CHUNK_ELEMS = 1 << 25


def geometry(bounds, g: Grid, width: int, height: int, max_radius_px: int,
             particle_size: float) -> dict:
    """Pixel strides, the patch margin (the sprite radius and one pixel of
    drift, within half a stride), the sprite's radius and edge, and the world
    to pixel map, each formed in float32."""
    x_min, x_max, y_min, y_max = (float(b) for b in bounds)
    sx_scale, sy_scale = width / (x_max - x_min), height / (y_max - y_min)
    sx, sy = int(round(g.cw * sx_scale)), int(round(g.cell * sy_scale))
    margin = max(min(max_radius_px + 1, min(sx, sy) // 2), max_radius_px)
    r = np.float32(particle_size) * np.float32(sx_scale)
    edge0 = np.float32(0.8) * r
    inv_w = np.float32(1.0) / max(r - edge0, np.float32(1e-6))
    f = lambda v: float(np.float32(v))
    return {"H": height, "W": width, "sx": sx, "sy": sy, "m": margin,
            "radius": float(r), "edge0": float(edge0), "inv_w": float(inv_w),
            "world": (f(x_min), f(y_max), f(sx_scale), f(sy_scale))}


def energy_color(vx, vy, max_energy: float):
    """(r, g) of the blue -> green -> red ramp on 0.5 |v|^2 / max_energy
    (blue is rebuilt from the sum rule r + g + b = 1)."""
    divisor = torch.full((), float(max_energy), dtype=torch.float32, device=vx.device)
    t = (0.5 * (vx * vx + vy * vy) / divisor).clamp(0.0, 1.0)
    low = t < 0.5
    hi = (t - 0.5) * 2.0
    return torch.where(low, 0.0, hi), torch.where(low, t * 2.0, 1.0 - hi)


def _clamp_center(q, radius: float, hi: float):
    qc = q.clamp(radius, float(np.float32(hi) - np.float32(radius)))
    return torch.where(q > 0.1 * FAR, q, qc)


def image(px, py, vx, vy, geo: dict, p: Params, pair_dtype=torch.float32):
    """The ``[H, W, 4]`` image of the planes, each sprite's centre clamped
    into its patch."""
    H, W, sx, sy, m = geo["H"], geo["W"], geo["sx"], geo["sy"], geo["m"]
    x_min, y_max, sx_scale, sy_scale = geo["world"]
    radius, edge0, inv_w = geo["radius"], geo["edge0"], geo["inv_w"]
    alive = live(px)
    ppx = torch.where(alive, (px - x_min) * sx_scale, FAR)
    ppy = torch.where(alive, (y_max - py) * sy_scale, FAR)
    cols = [torch.where(alive, c, 0.0) for c in energy_color(vx, vy, p.max_energy)]
    gh, gw, C = ppx.shape
    ph, pw = sy + 2 * m, sx + 2 * m
    dev = ppx.device
    patches = torch.zeros((3, gh, gw, ph, pw), dtype=torch.float32, device=dev)
    x0 = (torch.arange(gw, dtype=torch.float32, device=dev) * sx - m)[:, None]
    jc = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    ic = torch.arange(ph, dtype=torch.float32, device=dev) + 0.5
    step = max(1, CHUNK_ELEMS // (gw * C * ph * pw))
    for r0 in range(0, gh, step):
        r1 = min(gh, r0 + step)
        idx = torch.nonzero(live(px[r0:r1]).flatten(0, 1).any(0))
        if not idx.numel():
            continue
        c = int(idx.max()) + 1
        rows = torch.arange(r0, r1, dtype=torch.float32, device=dev)
        y0 = (H - (rows + 1) * sy - m)[:, None, None]
        qx = _clamp_center(ppx[r0:r1, :, :c] - x0, radius, pw)
        qy = _clamp_center(ppy[r0:r1, :, :c] - y0, radius, ph)
        dx = (jc - qx[..., None]).to(pair_dtype)
        dy = (ic - qy[..., None]).to(pair_dtype)
        d = torch.sqrt(dx[..., None, :] * dx[..., None, :] + dy[..., :, None] * dy[..., :, None])
        tt = ((d - edge0) * inv_w).clamp(0.0, 1.0)
        alpha = 1.0 - tt * tt * (3.0 - 2.0 * tt)
        alpha = torch.where(alpha < 0.01, 0.0, alpha)
        for k, col in enumerate(cols):
            patches[k, r0:r1] = (col[r0:r1, :, :c, None, None].to(pair_dtype) * alpha).float().sum(2)
        patches[2, r0:r1] = alpha.float().sum(2)
    blocks = patches.flip(1).permute(0, 3, 4, 1, 2).reshape(1, 3 * ph * pw, gh * gw)
    canvas = F.fold(blocks, (gh * sy + 2 * m, gw * sx + 2 * m), (ph, pw), stride=(sy, sx))[0]
    off = gh * sy - H
    acc = canvas[:, m + off: m + off + H, m: m + W]
    if acc.shape[2] < W:
        acc = F.pad(acc, (0, W - acc.shape[2]))
    rgb = torch.stack([acc[0], acc[1], float(np.float32(1.0)) * acc[2] - acc[0] - acc[1]], -1)
    a = acc[2]
    coverage = a.clamp(0.0, 1.0)[..., None]
    mean_rgb = rgb / a.clamp_min(1e-6)[..., None]
    return torch.cat([mean_rgb * coverage, coverage + (1.0 - coverage)], -1)
