"""Kernel K1 (``ops/dequant_gather.py``, ``csrc/gather_dequant.cu``): the least
time the card could take for the work of the requests answered in the
profiled slice, over K1's summed device time there, %.

The work of a request, whatever the program launches for it: each distinct
row it reads once (``dim`` int8 bytes and a 4-byte scale; the absent keys of
a table share its default row) and each key's ``dim`` float32 outputs
written once. Pad slots are not work. Bound by bytes at the card's HBM rate
(``peaks.json``)."""

import numpy as np

#: K1's kernel, as the profiler names it.
KERNEL = "grouped_gather_kernel"


def request_bytes(req, dim: int) -> int:
    total = 0
    for rows in req.rows:
        rows = np.asarray(rows)
        distinct = np.unique(rows[rows >= 0]).size + int((rows < 0).any())
        total += distinct * (dim + 4) + rows.size * dim * 4
    return total


def read(ctx):
    tr, peaks = ctx.trace, ctx.peaks
    if tr is None or peaks is None:
        return None
    k1_s = sum(o.end_us - o.start_us for o in tr.ops if KERNEL in o.name) / 1e6
    idx = ctx.answered_in(tr.t0, tr.t1)
    if k1_s <= 0 or idx.size == 0:
        return None
    dim = ctx.cfg["embedding_dim"]
    nbytes = sum(request_bytes(ctx.requests[e], dim) for e in ctx.results.entry[idx])
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / k1_s
