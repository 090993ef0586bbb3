"""Front end: the mean time an HTTP handler takes to read an infer request
(body off the socket, JSON header, tensor views; ``metrics.HTTP_READ_SECONDS``,
span ``hps.http.read``), over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_http_read_seconds")
    return None if m is None else m * 1e3
