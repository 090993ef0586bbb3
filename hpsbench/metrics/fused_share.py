"""Fused ensemble: the share of the window's answered requests that the fused
path served (the mean of ``metrics.ENSEMBLE_FUSED_PER_REQUEST``, 1 fused, 0
staged), over the window less the profiled slice, %. Below 100, work has
moved to the staged path."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_per_request")
    return None if m is None else 100.0 * m
