"""Dispatch: the mean time of a merged batch's key translation, assembly,
K1 and copy back (``metrics.BATCH_DISPATCH_SECONDS``), over the window, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_batch_dispatch_seconds")
    return None if m is None else m * 1e3
