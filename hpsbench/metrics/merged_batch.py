"""Batcher: the mean samples of a merged batch (``metrics.BATCH_SIZE``),
over the window."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    return window_mean(ctx, "hps_inference_batch_size")
