"""Fused ensemble: the mean enqueue of one request's K1, bottom MLP,
interaction and top MLP, no sync (``metrics.ENSEMBLE_FUSED_LAUNCH_SECONDS``,
span ``hps.ensemble.fused.launch``), over the window less the profiled slice,
ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_launch_seconds")
    return None if m is None else m * 1e3
