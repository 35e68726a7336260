"""launches_per_frame: kernels a frame launches (the profiler's kernel rows
over the traced frames, copies and fills by the copy engine left out; the
band with the most)."""

PATTERNS = (r".",)
NOT_KERNELS = (r"^Memcpy", r"^Memset")


def read(ranks) -> float | None:
    counts = []
    for r in ranks:
        ex = {id(o) for o in r.matching(NOT_KERNELS)}
        counts.append(sum(1 for o in r.ops if id(o) not in ex) / r.frames)
    return max(counts) if any(counts) else None
