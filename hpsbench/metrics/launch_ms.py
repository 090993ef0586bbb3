"""Dispatch: the mean time to enqueue a merged batch's K1 launch, the
output's slices and their concatenation (``metrics.DISPATCH_LAUNCH_SECONDS``,
span ``hps.dispatch.launch``), over the window less the profiled slice,
ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_dispatch_launch_seconds")
    return None if m is None else m * 1e3
