"""host_enqueue_ms: host milliseconds to enqueue one frame on a drained
stream (the slowest band's): the driver's and the launch layer's cost, which
sets the pace wherever it exceeds the device's frame."""


def read(ranks) -> float | None:
    return max(r.enqueue_ms for r in ranks)
