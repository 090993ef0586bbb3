"""Fused ensemble: the mean wait for the cache's lock and key -> slot
translation of one request, pad slots included
(``metrics.ENSEMBLE_FUSED_TRANSLATE_SECONDS``, span
``hps.ensemble.fused.translate``), over the window less the profiled slice,
ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_translate_seconds")
    return None if m is None else m * 1e3
