"""Dispatch: the mean assembly of a merged batch's kernel arguments (under
the cache's lock), their check, packing and the two host-to-device copies
(``metrics.DISPATCH_ASSEMBLE_SECONDS``, span ``hps.dispatch.assemble``),
over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_dispatch_assemble_seconds")
    return None if m is None else m * 1e3
