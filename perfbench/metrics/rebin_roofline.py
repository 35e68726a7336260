"""rebin_roofline: the rebin (K1; K7 on each band) against its bound.

Work of a frame, counted from the physics: every live particle's five
channels (x, y, vx, vy, id) read once and written once, 40 bytes, and about
10 operations to key it (two subtractions, two divisions, two floors, two
clamps, a compare); the bytes bound it.  The time is its kernel's device ms a
frame, summed over the bands."""

from harness import work

PATTERNS = (r"rebin_tile",)
BYTES_PER_PARTICLE = 40
OPS_PER_PARTICLE = 10


def ops(w: dict) -> float:
    return OPS_PER_PARTICLE * w["live"]


def read(ranks) -> float | None:
    ms = [t for t in (r.ms_per_frame(PATTERNS) for r in ranks) if t is not None]
    w = ranks[0].work
    if not ms or not w:
        return None
    return 100.0 * work.bound_s(ops(w), BYTES_PER_PARTICLE * w["live"]) * 1e3 / sum(ms)
