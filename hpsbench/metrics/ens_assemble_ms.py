"""Fused ensemble: the mean assembly of one request's lookup arguments (under
the cache's lock) and their and the dense features' uploads
(``metrics.ENSEMBLE_FUSED_ASSEMBLE_SECONDS``, span
``hps.ensemble.fused.assemble``), over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_ensemble_fused_assemble_seconds")
    return None if m is None else m * 1e3
