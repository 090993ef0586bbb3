"""Percentiles with failures counted as the slowest; the spread."""

import math

from hpsbench import stats


def test_percentile_nearest_rank():
    x = list(range(1, 101))
    assert stats.percentile(x, 95) == 95
    assert stats.percentile(x, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0


def test_failures_are_slowest():
    x = [1.0] * 95 + [math.inf] * 5
    assert stats.percentile(x, 95) == 1.0
    assert stats.percentile(x + [math.inf], 95) == math.inf
    assert stats.percentile([2.0, math.inf, 1.0], 50) == 2.0


def test_rate_leaves_out_the_profiled_slice():
    from types import SimpleNamespace

    import numpy as np

    from hpsbench.metrics import samples_per_s

    res = SimpleNamespace(entry=np.array([0, 1, 0, 1]), ok=np.array([True, True, False, True]),
                          done=np.array([1.0, 2.5, 3.0, 9.0]))
    reqs = [SimpleNamespace(samples=64), SimpleNamespace(samples=32)]
    ctx = SimpleNamespace(results=res, requests=reqs, window_s=10.0, untraced=None)
    assert samples_per_s.read(ctx) == (64 + 32 + 32) / 10.0
    ctx.untraced = (2.0, 4.0)  # the answer at 2.5 s and the slice's 2 s left out
    assert samples_per_s.read(ctx) == (64 + 32) / 8.0
