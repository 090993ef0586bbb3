"""Fused ensemble: the mean wait for the device and copy of one request's
logits to the host (``metrics.ENSEMBLE_FUSED_COPY_BACK_SECONDS``, span
``hps.ensemble.fused.copy_back``), over the window less the profiled slice,
ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_copy_back_seconds")
    return None if m is None else m * 1e3
