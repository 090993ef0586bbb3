"""Batcher: the mean time a request waits in the ``ContinuousBatcher`` queue
(``serving/scheduler.py``: ``metrics.QUEUE_LATENCY``), over the window, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_inference_queue_duration_seconds")
    return None if m is None else m * 1e3
