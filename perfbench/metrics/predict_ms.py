"""predict_ms: device ms a frame of the rows launched under the port's
``sph.predict`` span, gravity, the predict and the park of dead slots
(``predict_planes``), torch's kernels; the band
with the most.  None where the reading holds no such span."""

from harness import spans

SPAN = "sph.predict"


def read(ranks) -> float | None:
    return spans.ms_per_frame(ranks, SPAN)
