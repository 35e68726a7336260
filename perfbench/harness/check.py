"""The verdict on a run: every compared number at most its limit.

The numbers come from the model's judge (``models/<model>.py``), which holds
the program's output to the plain reference (``reference/``); the limits from
``limits/<cell>.json``.  A number with no limit there is exact: its limit is
0."""

from __future__ import annotations


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: [value, limit]}): every number at most its limit."""
    shown = {k: [v, limits.get(k, 0)] for k, v in numbers.items()}
    return all(v <= lim for v, lim in shown.values()), shown
