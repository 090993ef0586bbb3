"""K1: embedding gather + dequantize (``csrc/gather_dequant.cu``).

``out[n] = f32(values[slots[n]]) * s[n]`` with ``s`` the device scale of the
row (``scales[slots[n]]``), a host-gathered per-key scale (``scin[n]``) or 1.
This is the semantics of the JAX package's ``gather_dequant_xla`` followed by
the ``scin`` multiply of ``gather_rows_for_groups``; the one kernel serves the
arena, solo and one-hot lookup kinds (an int8 one-hot product is exact, so a
gather gives the same bits).

:func:`gather_dequant` launches the kernel for CUDA tensors and raises if it
cannot; it takes the plain version, :func:`gather_dequant_ref`, only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hugectr_backend_tpu_torch.ops import kernels

# Storage dtype -> the `kind` code of csrc/gather_dequant.cu.
_KIND = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
    torch.uint8: 4,  # nibble-packed int4
}

_bound = False


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, D//2] packed uint8 -> [N, D] f32 (even columns = low nibble)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], packed.shape[1] * 2).float()


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if values.dtype == torch.float8_e4m3fn:
        # Gather the raw bytes: index_select has no fp8 kernel on every device.
        return values.view(torch.uint8).index_select(0, idx).view(values.dtype)
    return values.index_select(0, idx)


def gather_dequant_ref(values: torch.Tensor, scales: Optional[torch.Tensor],
                       slots: torch.Tensor,
                       scin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: index_select + cast + multiply."""
    _check_scales(scales, scin)
    idx = slots.long()
    rows = _take_rows(values, idx)
    out = unpack_int4(rows) if rows.dtype == torch.uint8 else rows.float()
    if scales is not None:
        out = out * scales.index_select(0, idx)[:, None]
    if scin is not None:
        out = out * scin[:, None]
    return out


def _check_scales(scales, scin) -> None:
    if scales is not None and scin is not None:
        raise ValueError("pass device scales or per-key scales, not both")


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.hps_gather_dequant.restype = ctypes.c_int
    lib.hps_gather_dequant.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    _bound = True


def gather_dequant(values: torch.Tensor, scales: Optional[torch.Tensor],
                   slots: torch.Tensor,
                   scin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1. ``values`` [R, W] int8 / float8_e4m3fn / bfloat16 / float32, or
    uint8 nibble-packed int4 (W = D/2); ``scales`` [R] f32 or None; ``slots``
    [N] int32 in [0, R); ``scin`` [N] f32 or None. -> [N, D] f32.

    Slots are checked on the host before upload (cache/lookup_program.py);
    the kernel writes a NaN row for a slot out of range."""
    if values.device.type == "cpu":
        return gather_dequant_ref(values, scales, slots, scin)
    _check_scales(scales, scin)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"gather_dequant: unsupported device {dev}")
    if values.dtype not in _KIND:
        raise TypeError(f"gather_dequant: unsupported table dtype {values.dtype}")
    if values.dim() != 2 or not values.is_contiguous():
        raise ValueError("gather_dequant: values must be a contiguous [R, W] tensor")
    if slots.dtype != torch.int32 or slots.dim() != 1 or not slots.is_contiguous():
        raise ValueError("gather_dequant: slots must be a contiguous int32 [N] tensor")
    for name, t, n in (("scales", scales, values.shape[0]),
                       ("scin", scin, slots.shape[0])):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or not t.is_contiguous()):
            raise ValueError(f"gather_dequant: {name} must be contiguous f32 [{n}]")
    for t in (slots, scales, scin):
        if t is not None and t.device != dev:
            raise ValueError("gather_dequant: all tensors must be on one device")
    rows, width = values.shape
    n = slots.shape[0]
    d = width * 2 if values.dtype == torch.uint8 else width
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or width == 0:
        return out
    row_bytes = width * values.element_size()
    vec = int(row_bytes % 16 == 0 and values.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = kernels.library("gather_dequant")
    _bind(lib)
    rc = lib.hps_gather_dequant(
        dev.index, kernels.stream_of(values), _KIND[values.dtype],
        values.data_ptr(), rows, width, slots.data_ptr(), n,
        scales.data_ptr() if scales is not None else None,
        scin.data_ptr() if scin is not None else None,
        out.data_ptr(), vec,
    )
    kernels.check(lib, rc, "gather_dequant")
    kernels.launches["gather_dequant"] += 1
    return out
