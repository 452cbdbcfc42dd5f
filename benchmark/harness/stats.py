"""Percentile, rate and spread arithmetic of the benchmark."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_ms(due: list[float], done: list[float | None], gave_up: float) -> list[float]:
    """Every request's latency in ms, from when it was due to its reply.  A
    request with no reply (``None``: shed or failed) counts as later than
    every served one: the time from its due time until the benchmark stopped
    waiting (``gave_up``), and never less than the slowest served request."""
    served = [(d - t) * 1e3 for t, d in zip(due, done) if d is not None]
    slowest = max(served, default=0.0)
    return [(d - t) * 1e3 if d is not None else max(slowest, (gave_up - t) * 1e3)
            for t, d in zip(due, done)]


def rate(work: float, seconds: float) -> float:
    """Work over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds

