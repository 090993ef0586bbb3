"""Kernel K1 on the fused DLRM path: the least time the card could take for
K1's work of the requests answered in the profiled slice, over K1's summed
device time there, %.

K1 gathers only the tables the program reports it gathers (``_fold.split``;
the rest the interaction kernel folds): of each, each distinct row a request
reads once (``dim`` int8 bytes and a 4-byte scale; the absent keys share the
default row) and each key's ``dim`` float32 outputs written once. Pad slots
are not work. Bound by bytes at the card's HBM rate (``peaks.json``)."""

import types

from hpsbench.metrics import _fold, k1_roofline
from hpsbench.metrics.k1_roofline import KERNEL


def request_bytes(req, dim: int, gathered) -> int:
    """``k1_roofline``'s count over the gathered tables alone."""
    return k1_roofline.request_bytes(types.SimpleNamespace(rows=[req.rows[t] for t in gathered]),
                                     dim)


def read(ctx):
    tr, peaks = ctx.trace, ctx.peaks
    if tr is None or peaks is None:
        return None
    split = _fold.split(ctx)
    k1_s = sum(o.end_us - o.start_us for o in tr.ops if KERNEL in o.name) / 1e6
    idx = ctx.answered_in(tr.t0, tr.t1)
    if split is None or k1_s <= 0 or idx.size == 0:
        return None
    dim = ctx.cfg["embedding_dim"]
    nbytes = sum(request_bytes(ctx.requests[e], dim, split[0]) for e in ctx.results.entry[idx])
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / k1_s
