"""halo_ms: device ms a frame of the NCCL rows (the halo exchanges and the
diagnostics' all-reduce), the slowest band's.  Waiting for a peer counts: an
NCCL kernel runs until its partner's data has arrived."""

PATTERNS = (r"(?i)nccl",)


def read(ranks) -> float | None:
    ms = [t for t in (r.ms_per_frame(PATTERNS) for r in ranks) if t is not None]
    return max(ms) if ms else None
