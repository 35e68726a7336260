"""The yardstick of the rooflines: the card's published peaks, the bound, and
the counts of the physics' own work that a model's judge takes of a frame
(``models/sph.py``: the pairs within the radius at the positions the walks
see, after the reference's predict, rebin and defer mask; the sprite-pixel
pairs its image draws).  Nothing here reads the port's layout, its kernels'
instruction counts or the cell windows they sweep."""

from __future__ import annotations

import torch

from reference import sph as ref

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet: HBM3 bandwidth
FP32_OPS_S = 67e12  # the same: FP32 outside the tensor cores


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the FP32 rate and the bytes over the HBM rate."""
    return max(ops / FP32_OPS_S, nbytes / HBM_BYTES_S)


def sprite_pixels(cx, cy, radius: float, height: int, width: int) -> int:
    """(sprite, pixel) pairs a splat must evaluate: the pixel centres of the
    image within ``radius`` of each sprite centre (alpha is 0 at and beyond
    the radius)."""
    k = int(radius) + 2
    offs = torch.arange(-k, k + 1, dtype=torch.float32, device=cx.device)
    ix = torch.floor(cx)[:, None] + offs
    dx = ix + 0.5 - cx[:, None]
    in_x = (ix >= 0) & (ix < width)
    pairs = 0
    for o in range(-k, k + 1):
        iy = torch.floor(cy) + o
        dy = iy + 0.5 - cy
        in_y = (iy >= 0) & (iy < height)
        pairs += int((in_x & in_y[:, None]
                      & (dx * dx + (dy * dy)[:, None] < radius * radius)).sum())
    return pairs


def count_pairs(wx, wy, h: float, rows: slice = slice(None)) -> int:
    """Ordered pairs of walk-live slots closer than ``h`` (each slot with
    itself included), over the 3x3 cells that hold every such pair; of the
    slots in ``rows`` alone (a band's own rows, its ghost rows beside them)."""
    own_rows = torch.zeros(wx.shape[0], dtype=torch.bool, device=wx.device)
    own_rows[rows] = True
    pairs = 0
    for r0, r1, c in ref._chunks(wx):
        if not bool(own_rows[r0:r1].any()):
            continue
        ox, oy = wx[r0:r1, :, :c], wy[r0:r1, :, :c]
        nx, ny = ref._windows([(wx[..., :c], ref.SENTINEL), (wy[..., :c], ref.SENTINEL)],
                              r0, r1, wx.shape[1])
        dx = nx[:, :, None] - ox[..., None, None]
        dy = ny[:, :, None] - oy[..., None, None]
        own = ref.live(ox) & own_rows[r0:r1, None, None]
        pairs += int(((dx * dx + dy * dy < h * h) & own[..., None, None]).sum())
    return pairs


def image_census(out_planes, geo: dict) -> dict:
    """The image's work: the (sprite, pixel) pairs the frame's end planes
    draw, and the image's pixels."""
    px, py = out_planes[0], out_planes[1]
    m = ref.live(px)
    x_min, y_max, sx_scale, sy_scale = geo["world"]
    return {"sprite_pixels": sprite_pixels((px[m] - x_min) * sx_scale, (y_max - py[m]) * sy_scale,
                                           geo["radius"], geo["H"], geo["W"]),
            "sprites": int(m.sum()), "pixels": geo["H"] * geo["W"]}


def mean_census(frames: list) -> dict:
    keys = frames[0].keys()
    return {k: sum(f[k] for f in frames) / len(frames) for k in keys}
