"""density_roofline: the density walk (K2) against its bound.

Work of a frame, counted from the physics: the ordered pairs of walk-live
particles closer than the smoothing radius h, each with itself (the density
sums the self term), from the positions the walk takes (predicted, deferred
ones parked).  Per pair (rho += (h - d)^2, rhon += (h - d)^3): dx, dy (2),
d^2 (3), sqrt (1), h - d (1), squares and cube (2), two sums (2): 11
operations.  Bytes: each walk-live particle's x, y read once and its rho,
rhon written once, 16.  The operations bound it."""

from harness import work

PATTERNS = (r"strip_walk<.*DensityWalk",)
OPS_PER_PAIR = 11
BYTES_PER_PARTICLE = 16


def ops(w: dict) -> float:
    return OPS_PER_PAIR * w["density_pairs"]


def read(ranks) -> float | None:
    ms = [t for t in (r.ms_per_frame(PATTERNS) for r in ranks) if t is not None]
    w = ranks[0].work
    if not ms or not w:
        return None
    return 100.0 * work.bound_s(ops(w), BYTES_PER_PARTICLE * w["walk_live"]) * 1e3 / sum(ms)
