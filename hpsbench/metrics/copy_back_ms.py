"""Dispatch: the mean time a merged batch waits for the device and copies its
flat output to the host (``.cpu().numpy()``;
``metrics.DISPATCH_COPY_BACK_SECONDS``, span ``hps.dispatch.copy_back``),
over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_dispatch_copy_back_seconds")
    return None if m is None else m * 1e3
