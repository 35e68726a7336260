"""force_roofline: the force walk with the frame tail (K3) against its bound.

Work of a frame, counted from the physics: the ordered pairs of distinct
walk-live particles closer than h.  Per pair: dx, dy (2), d^2 (3), 1/d (1),
d (1), h - d (1), the pressure magnitude (P_i + P_j) v + (N_i + N_j) v^2 (6),
over d (1), the two force sums (4), u = h^2 - d^2 (1), u^3 (2), the three
viscosity sums (5): 27 operations.  Per live particle, the tail: the self
term (6), the viscosity combine (4), the velocity update (8), the Euler step
(6) and the bounce (4): 28.  Bytes: each live particle's nine inputs (walk x,
y, two pressure terms, vx, vy, the own near-pressure term, predicted x, y)
read once and four outputs written once, 52.  The operations bound it."""

from harness import work

PATTERNS = (r"strip_walk<.*ForceWalk",)
OPS_PER_PAIR = 27
OPS_PER_PARTICLE = 28
BYTES_PER_PARTICLE = 52


def ops(w: dict) -> float:
    return OPS_PER_PAIR * w["force_pairs"] + OPS_PER_PARTICLE * w["live"]


def read(ranks) -> float | None:
    ms = [t for t in (r.ms_per_frame(PATTERNS) for r in ranks) if t is not None]
    w = ranks[0].work
    if not ms or not w:
        return None
    return 100.0 * work.bound_s(ops(w), BYTES_PER_PARTICLE * w["live"]) * 1e3 / sum(ms)
