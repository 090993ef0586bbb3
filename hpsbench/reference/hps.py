"""Plain reference of an HPS model: row-wise symmetric quantization of the
fp32 tables, dequantized, gathered per request.

    scale[r] = max|row_r| / Q   (an all-zero row takes 1 / Q), float32
    q[r, :]  = clip(round_half_even(row_r / scale[r]), -Q, Q)
    out      = float32(q) * scale[r]           (one rounding; q is an integer,
                                                so a zero is +0.0)

Q is 127 for int8 (the configuration's precision) and 7 for int4 (the
control). An absent key gives the default vector. A response is table-major:
table 0's rows for every sample, then table 1's, ...
"""

from __future__ import annotations

import numpy as np

QMAX = {8: 127.0, 4: 7.0}


def dequantized(vectors: np.ndarray, bits: int = 8) -> np.ndarray:
    """The fp32 rows after quantization to ``bits`` and back, in float32."""
    q_max = QMAX[bits]
    v = np.asarray(vectors, np.float32)
    absmax = np.abs(v).max(axis=1)
    absmax = np.where(absmax == 0.0, np.float32(1.0), absmax)
    scale = (absmax / np.float32(q_max)).astype(np.float32)
    q = np.clip(np.rint(v / scale[:, None]), -q_max, q_max).astype(np.int8)
    return q.astype(np.float32) * scale[:, None]


class HpsReference:
    """``tables[t]``: table t's fp32 rows as the harness generated them.
    The dequantized tables are made once (``bits``: 8, or 4 for the
    control), kept as one array; ``response(rows)`` gives a request's
    OUTPUT0."""

    def __init__(self, tables, bits: int = 8, default_value: float = 0.0):
        self.deq = np.concatenate([dequantized(t, bits) for t in tables])
        self.offsets = np.cumsum([0] + [len(t) for t in tables])[:-1]
        self.dim = int(self.deq.shape[1])
        self.default_value = np.float32(default_value)

    def response(self, rows_per_table) -> np.ndarray:
        """A request's flat OUTPUT0 (table-major) from its row indices per
        table (-1: an absent key, which gets the default vector)."""
        rows = np.concatenate([np.asarray(r, np.int64) for r in rows_per_table])
        glob = np.concatenate([np.asarray(r, np.int64) + o
                               for r, o in zip(rows_per_table, self.offsets)])
        out = self.deq[np.where(rows < 0, 0, glob)]
        out[rows < 0] = self.default_value
        return out.reshape(-1)
