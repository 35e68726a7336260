"""frame_mfu: the whole frame's share of the cards' FP32 peak.

The operations the physics of a frame needs (the rebin's keys, the two walks
and the tail, and the image where the cell draws one, each counted by its
roofline's own reader) over the traced frame time (the slowest band's)
times the cards' peak.  A kernel taken off the path leaves its roofline
silent; this share still counts its work, so a gain claimed from a kernel's
roofline stays bounded by the whole frame's share of the peak.  The metric
is the one the benchmark's rules ask for beside the kernels' rooflines where
the system runs a model: the whole step's share of the chip's peak, named
with ``mfu``, moving the same end-to-end metric."""

from harness import spec, work

PARTS = ("rebin_roofline", "density_roofline", "force_roofline", "render_roofline")


def read(ranks) -> float | None:
    w = ranks[0].work
    if not w or not any(r.ops for r in ranks):
        return None
    ops = 0.0
    for name in PARTS:
        part = spec.metric(name)
        if name != "render_roofline" or "sprite_pixels" in w:
            ops += part.ops(w)
    frame_s = max(r.window_s / r.frames for r in ranks)
    return 100.0 * ops / (frame_s * len(ranks) * work.FP32_OPS_S)
