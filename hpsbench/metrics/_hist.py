"""The window's mean of one of the program's histograms (``serving/metrics.py``),
for the cell's model: (sum after - sum before) / (count after - count
before), less what the profiled slice added in a traced run. None where the
window observed nothing."""

from __future__ import annotations


def window_mean(ctx, name: str):
    count, total = ctx.hist.get(name, (0, 0.0))
    return total / count if count else None
