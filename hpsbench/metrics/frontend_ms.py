"""Front end: the client's mean latency (send to last byte) of the answered
requests minus the program's mean request time behind the HTTP handler
(``metrics.REQUEST_LATENCY``), over the window less the profiled slice
(requests open during it are left out on both sides), ms: what parsing,
encoding, the sockets and the handler threads add."""

import numpy as np

from hpsbench.metrics._hist import window_mean


def read(ctx):
    inner = window_mean(ctx, "hps_inference_request_duration_seconds")
    res = ctx.results
    sel = res.ok.copy()
    if ctx.untraced is not None:
        sel &= ~res.overlaps(*ctx.untraced)
    if inner is None or not sel.any():
        return None
    client = float(np.mean(res.done[sel] - res.sent[sel]))
    return (client - inner) * 1e3
