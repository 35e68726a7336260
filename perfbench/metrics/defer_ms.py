"""defer_ms: device ms a frame of the rows launched under the port's
``sph.defer`` span, the defer mask on the rebinned planes
(``walk_positions``), torch's kernels; the band
with the most.  None where the reading holds no such span."""

from harness import spans

SPAN = "sph.defer"


def read(ranks) -> float | None:
    return spans.ms_per_frame(ranks, SPAN)
