"""Rates and tails of a measured window."""

from __future__ import annotations

import math
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Work per second over the whole window: every unit completed over
    every second of it, stalls included."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) by the nearest-rank rule: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def samples_beyond(n: int, q: float) -> int:
    """How many of n samples lie beyond the q-th percentile's rank."""
    return n - max(1, math.ceil(q / 100.0 * n))
