"""Row-wise quantization for embedding tables (INT8, INT4 and FP8-e4m3).

Symmetric per-row absmax, as in the JAX package (its ops/quantize.py):

    scale[r]  = max(|row_r|) / Q          (Q = 127 int8, 7 int4, 448 fp8 e4m3)
    q[r, :]   = round(row_r / scale[r])
    row_r     ~= q[r, :] * scale[r]

int8 and int4 run on the native single-pass quantizer
(``native/kvstore.cpp hps_quantize_rows``, parallel over row chunks), as in
the JAX package; the numpy chains beside them (``quantize_rows_int8_ref``,
``quantize_rows_int4_ref``) are their plain versions, bit-identical, and
serve instead when ``HPS_TPU_NATIVE_QUANTIZE`` is "0" (read at each call;
any other value keeps the native quantizer, whose library must load). The fp8
cast goes through ``torch.float8_e4m3fn`` (round to nearest even, like
``ml_dtypes``), so fp8 rows come back as a CPU ``torch.Tensor``: numpy has no
8-bit float type.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

INT8_QMAX = 127.0
INT4_QMAX = 7.0
FP8_E4M3_MAX = 448.0


def _row_scales(vectors: np.ndarray, qmax: float) -> np.ndarray:
    absmax = np.abs(vectors).max(axis=1)
    # Avoid zero scales for all-zero rows; any finite scale dequantizes 0 -> 0.
    absmax = np.where(absmax == 0.0, 1.0, absmax)
    return (absmax / qmax).astype(np.float32)


def _native_quantizer() -> bool:
    """``HPS_TPU_NATIVE_QUANTIZE`` (the JAX package's switch), read per call:
    "0" takes the numpy chains."""
    return os.environ.get("HPS_TPU_NATIVE_QUANTIZE", "1") != "0"


def _native_quantize(vectors: np.ndarray, order, mode: int):
    """``hps_quantize_rows`` (mode 8: int8, 4: packed int4). -> (q, scales);
    output row i quantizes ``vectors[order[i]]`` (``vectors[i]`` without
    ``order``)."""
    from hugectr_backend_tpu_torch.native.kvstore import load_lib

    vectors = np.ascontiguousarray(vectors, np.float32)
    n, dim = vectors.shape
    if order is None:
        rows_out, op = n, None
    else:
        order = np.ascontiguousarray(order, np.int64).reshape(-1)
        if order.size and (int(order.min()) < 0 or int(order.max()) >= n):
            raise IndexError(f"order holds rows outside [0, {n})")
        rows_out = int(order.shape[0])
        op = order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    q = np.empty((rows_out, dim if mode == 8 else dim // 2),
                 np.int8 if mode == 8 else np.uint8)
    scales = np.empty(rows_out, np.float32)
    load_lib().hps_quantize_rows(
        rows_out, dim, vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        op, q.ctypes.data_as(ctypes.c_void_p),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), mode)
    return q, scales


def quantize_rows_int8(vectors: np.ndarray, order: np.ndarray | None = None):
    """-> (q int8 [rows, dim], scales float32 [rows]), on the native
    quantizer.

    ``order`` (optional): output row i quantizes source row ``order[i]``."""
    if not _native_quantizer():
        return quantize_rows_int8_ref(vectors, order)
    return _native_quantize(np.asarray(vectors, dtype=np.float32), order, mode=8)


def quantize_rows_int8_ref(vectors: np.ndarray, order: np.ndarray | None = None):
    """The plain version of :func:`quantize_rows_int8` (the numpy chain)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    if order is not None:
        vectors = vectors[order]
    scales = _row_scales(vectors, INT8_QMAX)
    q = np.rint(vectors / scales[:, None])
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, scales


def quantize_rows_fp8(vectors: np.ndarray):
    """-> (q CPU tensor float8_e4m3fn [rows, dim], scales float32 [rows])."""
    vectors = np.asarray(vectors, dtype=np.float32)
    scales = _row_scales(vectors, FP8_E4M3_MAX)
    scaled = vectors / scales[:, None]
    return torch.from_numpy(np.ascontiguousarray(scaled)).to(torch.float8_e4m3fn), scales


def quantize_rows_int4(vectors: np.ndarray, order: np.ndarray | None = None):
    """Symmetric INT4 row quantization, nibble-packed, on the native
    quantizer.

    -> (packed uint8 [rows, dim//2], scales float32 [rows]); even columns in
    the LOW nibble, odd in the HIGH. Requires an even dim.
    """
    vectors = np.asarray(vectors, dtype=np.float32)
    if vectors.shape[1] % 2:
        raise ValueError("int4 quantization requires an even embedding dim")
    if not _native_quantizer():
        return quantize_rows_int4_ref(vectors, order)
    return _native_quantize(vectors, order, mode=4)


def quantize_rows_int4_ref(vectors: np.ndarray, order: np.ndarray | None = None):
    """The plain version of :func:`quantize_rows_int4` (the numpy chain)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    if vectors.shape[1] % 2:
        raise ValueError("int4 quantization requires an even embedding dim")
    if order is not None:
        vectors = vectors[order]
    scales = _row_scales(vectors, INT4_QMAX)
    q = np.clip(np.rint(vectors / scales[:, None]), -7, 7).astype(np.int8)
    return pack_int4(q), scales


def dequantize_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Host-side reference dequant: q * scale[:, None] -> float32."""
    return q.astype(np.float32) * np.asarray(scales, dtype=np.float32)[:, None]


def pack_int4(q: np.ndarray) -> np.ndarray:
    """int8 values in [-8, 7], even dim -> packed uint8 [rows, dim//2]."""
    u = (q.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def unpack_int4(p: np.ndarray) -> np.ndarray:
    """packed uint8 [rows, dim//2] -> int8 [rows, dim] (sign-extended)."""
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo).astype(np.int8)
    hi = np.where(hi >= 8, hi - 16, hi).astype(np.int8)
    out = np.empty((p.shape[0], p.shape[1] * 2), np.int8)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out


def dequantize_rows_int4(p: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Host-side reference dequant of packed int4 rows -> float32."""
    return dequantize_rows(unpack_int4(p), scales)
