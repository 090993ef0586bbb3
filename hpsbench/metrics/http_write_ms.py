"""Front end: the mean time an HTTP handler takes to write an answer (header
JSON and OUTPUT0 handed to the socket; ``metrics.HTTP_WRITE_SECONDS``, span
``hps.http.write``), over the window less the profiled slice, ms."""

from hpsbench.metrics._hist import window_mean


def read(ctx):
    m = window_mean(ctx, "hps_http_write_seconds")
    return None if m is None else m * 1e3
