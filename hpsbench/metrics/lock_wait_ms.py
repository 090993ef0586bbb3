"""Dispatch: the mean wait of a merged batch's lookup for the embedding
cache's lock (``metrics.DISPATCH_LOCK_WAIT_SECONDS``, span
``hps.dispatch.lock_wait``), over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_dispatch_lock_wait_seconds")
    return None if m is None else m * 1e3
