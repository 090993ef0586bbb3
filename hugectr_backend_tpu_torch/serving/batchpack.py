"""Batch merge/regroup for the continuous batcher.

Port of the JAX package's serving/batchpack.py. The batcher's two data
motions — concatenating N requests' per-table key runs into merged per-table
buffers, and splitting the flat table-major lookup output back per request —
are pure memcpy with precomputed geometry. Each direction is ONE
GIL-released native call (``native/kvstore.cpp hps_merge_requests`` /
``hps_regroup_responses``); the Python slice loops beside them
(``merge_requests_ref``, ``regroup_responses_ref``) are their plain
versions, bit-identical, which the tests hold them against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from hugectr_backend_tpu_torch.native.kvstore import load_lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _merge_layout(keys_list, counts, totals):
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n_reqs, n_tables = counts.shape
    if len(keys_list) != n_reqs:
        raise ValueError(f"{len(keys_list)} key buffers for {n_reqs} rows of counts")
    for r, k in enumerate(keys_list):
        if k.dtype != np.int64 or not k.flags.c_contiguous or k.ndim != 1:
            raise ValueError(f"request {r}: KEYS must be a contiguous 1-D int64 array")
        if k.shape[0] < counts[r].sum():
            raise ValueError(f"request {r}: {k.shape[0]} keys, counts sum to "
                             f"{int(counts[r].sum())}")
    if totals is None:
        totals = counts.sum(axis=0)
    starts = np.zeros(n_tables + 1, np.int64)
    np.cumsum(totals, out=starts[1:])
    buf = np.empty(int(starts[-1]), np.int64)
    merged = [buf[starts[t]: starts[t + 1]] for t in range(n_tables)]
    return counts, starts, buf, merged


def merge_requests(
    keys_list: Sequence[np.ndarray],
    counts: np.ndarray,
    totals: Optional[np.ndarray] = None,
) -> "list[np.ndarray]":
    """-> merged per-table int64 key arrays (views into one buffer).

    ``keys_list[r]``: request r's flat KEYS (table-major, contiguous int64);
    ``counts``: [n_reqs, n_tables] int64 NUMKEYS matrix.
    """
    counts, starts, buf, merged = _merge_layout(keys_list, counts, totals)
    n_reqs, n_tables = counts.shape
    if n_reqs:
        src = (ctypes.c_void_p * n_reqs)(*(k.ctypes.data for k in keys_list))
        load_lib().hps_merge_requests(n_reqs, n_tables, src, _ptr(counts),
                                      _ptr(starts), _ptr(buf))
    return merged


def merge_requests_ref(keys_list, counts, totals=None) -> "list[np.ndarray]":
    """The plain version of :func:`merge_requests`."""
    counts, _, _, merged = _merge_layout(keys_list, counts, totals)
    n_reqs, n_tables = counts.shape
    offs = np.zeros((n_reqs, n_tables + 1), np.int64)
    np.cumsum(counts, axis=1, out=offs[:, 1:])
    for t in range(n_tables):
        pos = 0
        m = merged[t]
        for r in range(n_reqs):
            n = int(counts[r, t])
            m[pos: pos + n] = keys_list[r][offs[r, t]: offs[r, t + 1]]
            pos += n
    return merged


def _regroup_layout(flat, tstarts, dims, counts):
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n_reqs, n_tables = counts.shape
    tstarts = np.ascontiguousarray(tstarts, dtype=np.int64)
    dims = np.ascontiguousarray(dims, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)
    if tstarts.shape != (n_tables,) or dims.shape != (n_tables,):
        raise ValueError("tstarts and dims need one entry per table")
    if n_tables and (tstarts + counts.sum(axis=0) * dims).max(initial=0) > flat.shape[0]:
        raise ValueError("a table's run reaches past the end of flat")
    sizes = counts @ dims  # [n_reqs] floats per request
    offsets = np.zeros(n_reqs + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    out = np.empty(int(offsets[-1]), np.float32)
    return counts, tstarts, dims, flat, out, offsets


def regroup_responses(
    flat: np.ndarray,
    tstarts: np.ndarray,
    dims: np.ndarray,
    counts: np.ndarray,
) -> "tuple[np.ndarray, np.ndarray]":
    """Table-major padded ``flat`` -> (request-major buffer, req offsets).

    Request r's response is the zero-copy view
    ``buf[offsets[r]:offsets[r+1]]``. ``tstarts[t]``: element offset of
    table t's (padded) run in ``flat``; ``dims[t]``: row width;
    ``counts``: [n_reqs, n_tables] rows per (request, table).
    """
    counts, tstarts, dims, flat, out, offsets = _regroup_layout(flat, tstarts, dims, counts)
    n_reqs, n_tables = counts.shape
    load_lib().hps_regroup_responses(n_reqs, n_tables, _ptr(flat), _ptr(tstarts),
                                     _ptr(dims), _ptr(counts), _ptr(out))
    return out, offsets


def regroup_responses_ref(flat, tstarts, dims, counts):
    """The plain version of :func:`regroup_responses`."""
    counts, tstarts, dims, flat, out, offsets = _regroup_layout(flat, tstarts, dims, counts)
    n_reqs, n_tables = counts.shape
    in_off = np.zeros(n_tables, np.int64)
    dst = 0
    for r in range(n_reqs):
        for t in range(n_tables):
            n = int(counts[r, t]) * int(dims[t])
            lo = int(tstarts[t]) + int(in_off[t]) * int(dims[t])
            out[dst: dst + n] = flat[lo: lo + n]
            in_off[t] += counts[r, t]
            dst += n
    return out, offsets
