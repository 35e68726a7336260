"""device_idle_share: the share of the traced cycle in which no device
operation ran, averaged over the cards (1 - busy / window)."""


def read(ranks) -> float | None:
    if not any(r.ops for r in ranks):
        return None
    return 100.0 * sum(1.0 - r.busy_s() / r.window_s for r in ranks) / len(ranks)
