"""Statistics of a run, over all requests of the window."""

from __future__ import annotations

import math

import numpy as np


def percentile(latencies, q: float) -> float:
    """The q-th percentile (0-100, nearest rank) of ``latencies``, where a
    failed or refused request is ``inf``: slower than every answered one.
    inf when the rank falls on a failure."""
    x = np.sort(np.asarray(latencies, np.float64))
    if x.size == 0:
        return math.inf
    rank = max(int(math.ceil(q / 100.0 * x.size)), 1)
    return float(x[rank - 1])


def lateness(due, sent) -> dict:
    """The generator's lateness (sent - due, seconds): median, p99, max, and
    whether it grew: the median of the last quarter of the window minus that
    of the first."""
    late = np.asarray(sent, np.float64) - np.asarray(due, np.float64)
    if late.size == 0:
        return {"p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0, "growth_s": 0.0}
    order = np.argsort(due)
    q = max(late.size // 4, 1)
    return {"p50_s": float(np.median(late)), "p99_s": percentile(late, 99),
            "max_s": float(late.max()),
            "growth_s": float(np.median(late[order[-q:]]) - np.median(late[order[:q]]))}


def timeline(t, latency, ok, step: float) -> list:
    """[(n, p50 ms, p95 ms)] of the answered requests in each ``step``
    seconds of ``t`` (for the run's log: whether the tail is steady)."""
    t, latency, ok = (np.asarray(a) for a in (t, latency, ok))
    out = []
    for k in range(int(np.ceil(t.max() / step)) if t.size else 0):
        sel = ok & (t >= k * step) & (t < (k + 1) * step)
        lat = np.sort(latency[sel]) * 1e3
        out.append((int(sel.sum()), round(percentile(lat, 50), 2) if lat.size else None,
                    round(percentile(lat, 95), 2) if lat.size else None))
    return out
