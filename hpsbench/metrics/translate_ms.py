"""Dispatch: the mean key -> slot translation of a merged batch, slot padding
included, under the cache's lock (``metrics.DISPATCH_TRANSLATE_SECONDS``,
span ``hps.dispatch.translate``), over the window less the profiled slice,
ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_dispatch_translate_seconds")
    return None if m is None else m * 1e3
