"""pressure_ms: device ms a frame of the rows launched under the port's
``sph.pressure`` span, the per-slot pressure terms between the
walks (``pressure_terms``), torch's kernels; the band
with the most.  None where the reading holds no such span."""

from harness import spans

SPAN = "sph.pressure"


def read(ranks) -> float | None:
    return spans.ms_per_frame(ranks, SPAN)
