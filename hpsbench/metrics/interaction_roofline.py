"""Kernels K2/K3, the DLRM dot interaction on the fused path: the least time
the card could take for its work of the requests answered in the profiled
slice, over the ``dot_interaction`` kernels' summed device time there, %.

The work of a request of B samples with F = T + 1 features of ``dim``:
reading each sample's bottom vector and the vector of each table that K1
gathered (``dim`` float32 each), each distinct row of each table the kernel
folds once (``dim`` int8 bytes and a 4-byte scale; the absent keys share the
default row), and writing each sample's ``dim + F(F-1)/2`` float32 outputs.
No pads. The tables are split as the program reports (``_fold.split``), so
the same work is counted whether K2 or K3 does it. Bound by bytes at the
card's HBM rate (``peaks.json``)."""

import numpy as np

from hpsbench.metrics import _fold

#: The interaction kernels, as the profiler names them (the backward's
#: kernels are not on the serving path).
KERNEL = "dot_interaction"


def distinct_rows(rows) -> int:
    """A table's distinct present rows, and the default row where a key is
    absent."""
    rows = np.asarray(rows)
    return int(np.unique(rows[rows >= 0]).size + int((rows < 0).any()))


def request_bytes(req, dim: int, gathered, folded) -> int:
    feats = len(gathered) + len(folded) + 1
    reads = req.samples * (len(gathered) + 1) * dim * 4
    reads += sum(distinct_rows(req.rows[t]) * (dim + 4) for t in folded)
    return reads + req.samples * (dim + feats * (feats - 1) // 2) * 4


def read(ctx):
    tr, peaks = ctx.trace, ctx.peaks
    if tr is None or peaks is None:
        return None
    split = _fold.split(ctx)
    k_s = sum(o.end_us - o.start_us for o in tr.ops
              if KERNEL in o.name and "bwd" not in o.name) / 1e6
    idx = ctx.answered_in(tr.t0, tr.t1)
    if split is None or k_s <= 0 or idx.size == 0:
        return None
    dim = ctx.cfg["embedding_dim"]
    nbytes = sum(request_bytes(ctx.requests[e], dim, *split) for e in ctx.results.entry[idx])
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / k_s
