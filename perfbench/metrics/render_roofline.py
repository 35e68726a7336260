"""render_roofline: the plane render (K4, world planes in, image out)
against its bound.

Work of a frame, counted from the physics: the (sprite, pixel) pairs whose
pixel centre lies within the sprite's radius (alpha is 0 beyond it).  Per
pair: dx, dy (2), d^2 (3), sqrt (1), the edge ramp (2) and its clamp (2), the
smoothstep (5), the cut below 0.01 (1), the sums of r a, g a and a (5): 21
operations; per sprite the world-to-pixel map and the energy colour, 16.
Bytes: each sprite's x, y, vx, vy read once (16) and the RGBA float image
written once (16 a pixel)."""

from harness import work

PATTERNS = (r"render_kernel",)
OPS_PER_PAIR = 21
OPS_PER_SPRITE = 16


def ops(w: dict) -> float:
    return OPS_PER_PAIR * w["sprite_pixels"] + OPS_PER_SPRITE * w["sprites"]


def read(ranks) -> float | None:
    ms = [t for t in (r.ms_per_frame(PATTERNS) for r in ranks) if t is not None]
    w = ranks[0].work
    if not ms or not w or "sprite_pixels" not in w:
        return None
    nbytes = 16 * w["sprites"] + 16 * w["pixels"]
    return 100.0 * work.bound_s(ops(w), nbytes) * 1e3 / sum(ms)
