"""count_ms: device ms a frame of the rows launched under the port's
``sph.count`` span, the particle bookkeeping (the live count,
``kept`` and ``lost``, the ids' re-park), torch's kernels; the band
with the most.  None where the reading holds no such span."""

from harness import spans

SPAN = "sph.count"


def read(ranks) -> float | None:
    return spans.ms_per_frame(ranks, SPAN)
