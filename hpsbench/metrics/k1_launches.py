"""Kernel K1: its mean launches a merged batch
(``metrics.K1_LAUNCHES_PER_BATCH``, counted on the batcher's thread), over
the window less the profiled slice."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    return window_mean(ctx, "hps_k1_launches_per_batch")
