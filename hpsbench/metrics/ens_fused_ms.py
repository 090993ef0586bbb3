"""Fused ensemble: the mean device program of one request, keys in to logits
on the host (``metrics.ENSEMBLE_FUSED_SECONDS``, span ``hps.ensemble.fused``),
over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_seconds")
    return None if m is None else m * 1e3
