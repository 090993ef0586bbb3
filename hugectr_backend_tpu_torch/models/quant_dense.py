"""Quantized dense layers (int8 / fp8-e4m3 weight-only, and w8a8) for serving.

Port of the JAX package's models/quant_dense.py. Weights are quantized per
output column, symmetric absmax, and stored ``[out, in]`` (the ``nn.Linear``
layout, the transpose of the Flax kernel):

- ``"int8"`` / ``"fp8"``: weight-only. The layer computes
  ``act(x @ (f32(q) * scale)^T + bias)`` with a library matmul, as the JAX
  package leaves this product to XLA.
- ``"w8a8"``: the activations are quantized too, per row, at run time, and
  the layer runs K5 (:func:`~hugectr_backend_tpu_torch.ops.quant_matmul.w8a8_dense`)
  with the activation fused into its epilogue. ``kernel_q`` is then the
  ``[out, in]`` view of rows zero-padded to 16 bytes (479 -> 480 at the
  DLRM's first top layer), which K5 reads whole (:meth:`QuantDense.k5_weight`),
  so that it may take its ``wgmma`` plan; the state_dict keeps ``[out, in]``.

With ``compute_dtype`` bf16, as the JAX layer: the weight-only product
takes the weights dequantized in bf16 (``bf16(q) * bf16(scale)``, one
rounding) and the bf16 input, sums in f32, adds the bias and applies the
activation in f32, then casts to bf16; w8a8 runs K5 on the f32 cast of the
input and casts its f32 output.

A :class:`QuantDense` is built from carried (:func:`~hugectr_backend_tpu_torch.
models.dlrm.load_flax_dlrm_params`) or quantized (:func:`quantize_model_params`)
weights; it has no random init of its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hugectr_backend_tpu_torch.ops.quant_matmul import (
    _ACTS,
    INT8_QMAX,
    k5_rows,
    pad_k16,
    quantize_activations,
    w8a8_dense,
)
from hugectr_backend_tpu_torch.ops.quantize import FP8_E4M3_MAX

FORMATS = ("int8", "fp8", "w8a8")

__all__ = [
    "FORMATS",
    "QuantDense",
    "linear",
    "mixed_operands",
    "quantize_activations",
    "quantize_dense_params",
    "quantize_model_params",
    "quantize_weight",
]


def quantize_weight(w, fmt: str = "int8"):
    """[out, in] f32 -> (q [out, in] int8 or float8_e4m3fn, scale [out] f32),
    symmetric per output column. The bytes equal the JAX package's
    ``quantize_weight`` of the ``[in, out]`` transpose."""
    w = np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w, np.float32)
    absmax = np.abs(w).max(axis=1)
    absmax = np.where(absmax == 0, 1.0, absmax)
    if fmt in ("int8", "w8a8"):
        scale = (absmax / INT8_QMAX).astype(np.float32)
        q = torch.from_numpy(np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8))
    elif fmt == "fp8":
        scale = (absmax / FP8_E4M3_MAX).astype(np.float32)
        q = torch.from_numpy(np.ascontiguousarray(w / scale[:, None])).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quant format {fmt!r} (one of {FORMATS})")
    return q, torch.from_numpy(scale)


def mixed_operands(mixed_precision: bool, *ts: torch.Tensor) -> tuple:
    """The operands of a product, as ``use_mixed_precision`` has them: with
    ``mixed_precision`` each is rounded to bf16 and upcast again, so that an
    f32 product of them is exact and only the sums round (f32
    accumulation), as in the JAX package; else unchanged."""
    if not mixed_precision:
        return ts
    return tuple(t.to(torch.bfloat16).float() for t in ts)


def linear(x: torch.Tensor, w: torch.Tensor, mixed_precision: bool = False) -> torch.Tensor:
    """``x @ w^T`` in f32, with :func:`mixed_operands`."""
    return F.linear(*mixed_operands(mixed_precision, x, w))


class QuantDense(nn.Module):
    """Dense layer on a quantized kernel: buffers ``kernel_q`` [out, in]
    (int8, or float8_e4m3fn for ``fmt="fp8"``), ``kernel_scale`` [out] f32
    and ``bias`` [out] f32 (absent with ``use_bias=False``). ``activation``:
    None, "relu", "sigmoid", "tanh" or "gelu", fused into the layer."""

    def __init__(self, in_features: int, out_features: int, fmt: str = "int8",
                 use_bias: bool = True, activation: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if fmt not in FORMATS:
            raise ValueError(f"unknown quant format {fmt!r} (one of {FORMATS})")
        if activation not in _ACTS:
            raise ValueError(f"unknown activation {activation!r}")
        self.fmt, self.activation, self.compute_dtype = fmt, activation, compute_dtype
        qdtype = torch.float8_e4m3fn if fmt == "fp8" else torch.int8
        kernel_q = torch.zeros(out_features, in_features, dtype=qdtype)
        self.register_buffer("kernel_q", pad_k16(kernel_q) if fmt == "w8a8" else kernel_q)
        self.register_buffer("kernel_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if use_bias else None)

    def _apply(self, fn, recurse=True):
        # .to() and the like copy the [out, in] view alone: pad it again.
        super()._apply(fn, recurse)
        if self.fmt == "w8a8":
            self.kernel_q = pad_k16(self.kernel_q)
        return self

    def k5_weight(self) -> torch.Tensor:
        """``kernel_q`` as K5 reads it: the padded rows behind it
        (:func:`~hugectr_backend_tpu_torch.ops.quant_matmul.k5_rows`), no
        copy. ``load_state_dict`` writes into them in place; a ``kernel_q``
        assigned in another layout is padded at each call."""
        return k5_rows(self.kernel_q)

    def forward(self, x: torch.Tensor, kernel_q: Optional[torch.Tensor] = None,
                mixed_precision: bool = False) -> torch.Tensor:
        """``kernel_q`` replaces the stored one (the serving path's
        column-permuted copy), as given. ``mixed_precision`` rounds the
        weight-only product's operands to bf16; w8a8 is int8 either way."""
        cd = self.compute_dtype
        if self.fmt == "w8a8":
            wq = self.k5_weight() if kernel_q is None else kernel_q
            y = w8a8_dense(x.float().contiguous(), wq, self.kernel_scale, self.bias,
                           self.activation)
            return y if cd == torch.float32 else y.to(cd)
        wq = self.kernel_q if kernel_q is None else kernel_q
        if cd == torch.float32:
            y = linear(x, wq.float() * self.kernel_scale[:, None], mixed_precision)
        else:
            # The operands rounded to cd and upcast: their f32 product is
            # exact, so only the sums round (f32 accumulation).
            w = wq.to(cd) * self.kernel_scale.to(cd)[:, None]
            y = F.linear(x.to(cd).float(), w.float())
        if self.bias is not None:
            y = y + self.bias
        y = _ACTS[self.activation](y)
        return y if cd == torch.float32 else y.to(cd)


def quantize_dense_params(state: dict, fmt: str = "int8") -> dict:
    """A state_dict of ``nn.Linear`` layers (``<layer>.weight`` [out, in],
    ``<layer>.bias``) -> the :class:`QuantDense` layout (``<layer>.kernel_q``,
    ``<layer>.kernel_scale``, ``<layer>.bias``). Other entries pass through."""
    out = {}
    for name, t in state.items():
        if name.endswith(".weight") and t.dim() == 2 and t.is_floating_point():
            q, s = quantize_weight(t, fmt)
            prefix = name[: -len("weight")]
            out[prefix + "kernel_q"] = q
            out[prefix + "kernel_scale"] = s
        else:
            out[name] = t
    return out


def quantize_model_params(state: dict, fmt: str = "int8") -> dict:
    """A whole model's f32 state_dict -> the state_dict of the same model
    built with ``quant_fmt=fmt``, so an f32 checkpoint deploys quantized
    without retraining. The port's layer names do not carry the layer kind
    (the JAX package renames ``Dense_i`` to ``QuantDense_i``), so this is
    :func:`quantize_dense_params` over every layer."""
    return quantize_dense_params(state, fmt)
