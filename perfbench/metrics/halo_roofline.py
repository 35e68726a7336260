"""halo_roofline: the halo exchanges against the link's bound.

Work of a frame: the bytes the band that receives most takes in, counted by
the judge from the layout and the exchanges of the sharded step
(``halo_bytes``).  The bound is those bytes at 450 GB/s, one direction of an
H100 SXM's NVLink (NVIDIA H100 SXM data sheet: 900 GB/s in all); a band's
receives from its two neighbours share it.  The time is ``halo_ms``: the
slowest band's NCCL rows a frame, waiting for a peer included, so the share
stays under 100% by construction."""

from harness import spec

NVLINK_BYTES_S = 450e9  # per direction


def read(ranks) -> float | None:
    w = ranks[0].work
    ms = spec.metric("halo_ms").read(ranks)
    if not ms or not w or "halo_bytes" not in w:
        return None
    return 100.0 * w["halo_bytes"] / NVLINK_BYTES_S * 1e3 / ms
