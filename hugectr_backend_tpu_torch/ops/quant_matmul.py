"""K5: the w8a8 dense layer (``csrc/w8a8_dense.cu``).

One layer ``y = act(f32(xq @ wq^T) * xs * wscale + bias)`` with the
activations quantized on the fly, per row, to symmetric int8:

    xs = max(max|x_row|, 1e-12) / 127        (an IEEE divide, not * 1/127)
    xq = clip(round_half_even(x / xs), -127, 127)

This is the semantics of the JAX package's ``w8a8_dense`` (its Pallas body
``_kernel`` and the XLA formulation ``xla_w8a8``). The weight is stored
``[N, K]`` (the ``nn.Linear`` layout, K contiguous), the transpose of the
JAX package's ``[K, N]``; ``wscale`` is per output column. ``wq`` may carry
columns past K (rows padded to a multiple of 16 bytes, which the kernel
reads with 16-byte copies); they are ignored.

:func:`w8a8_dense` launches the kernel for CUDA tensors and raises if it
cannot; it takes the plain version, :func:`w8a8_dense_plain`, only for CPU
tensors. The kernel takes any M, N and K up to :data:`MAX_K`: there are no
alignment gates. The layer has no backward: under autograd it raises rather
than return a result cut from the graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from hugectr_backend_tpu_torch.ops import kernels

INT8_QMAX = 127.0

#: Activation name -> plain PyTorch function. ``gelu`` is the tanh form
#: (``jax.nn.gelu``'s default).
_ACTS = {
    None: lambda y: y,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
}

# Activation name -> the `act` code of csrc/w8a8_dense.cu.
_ACT_CODE = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3, "gelu": 4}

#: The largest K the kernel takes: the CTA keeps its 64 quantized rows of x,
#: K padded to a multiple of 64, beside a 4-stage weight ring in shared
#: memory (227 KB on an H100).
MAX_K = 2944

_bound = False


def quantize_activations(x: torch.Tensor):
    """Dynamic symmetric per-row int8: [.., K] -> (xq int8, xs [.., 1] f32)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor on the tensor's device: PyTorch's CUDA divide by a
    # Python scalar multiplies by its reciprocal instead, one ulp off.
    xs = absmax.clamp_min(1e-12) / torch.full_like(absmax, INT8_QMAX)
    xq = torch.round(x / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def _check_args(x, wq, wscale, bias, act) -> None:
    if act not in _ACTS:
        raise ValueError(f"w8a8_dense: unknown activation {act!r} (one of {list(_ACTS)})")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] > wq.shape[1]:
        raise ValueError(f"w8a8_dense: x [M, K] and wq [N, >= K] expected, got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.shape[1] == 0:
        raise ValueError("w8a8_dense: K must be positive")
    n = wq.shape[0]
    for name, t in (("wscale", wscale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"w8a8_dense: {name} must be [{n}], got {tuple(t.shape)}")


def w8a8_dense_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of K5. The int8 product accumulates in float64,
    which is exact (|acc| <= 127^2 K < 2^53), and runs on the CPU and the
    card alike: an int8 matmul would wrap on the CPU, and CUDA has no int32
    matmul."""
    _check_args(x, wq, wscale, bias, act)
    xq, xs = quantize_activations(x.float())
    acc = (xq.double() @ wq[:, : x.shape[1]].double().T).float()
    y = acc * xs * wscale
    if bias is not None:
        y = y + bias
    return _ACTS[act](y)


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.hps_w8a8_dense.restype = ctypes.c_int
    lib.hps_w8a8_dense.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    _bound = True


def w8a8_dense(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """K5. ``x`` [M, K] f32, ``wq`` [N, >= K] int8, ``wscale`` [N] f32, ``bias``
    [N] f32 or None, ``act`` one of None, "relu", "sigmoid", "tanh", "gelu"
    (fused into the epilogue). -> [M, N] f32. Forward-only, as in the JAX
    package: raises when autograd would record it."""
    kernels.forward_only("w8a8_dense", x, wscale, bias)
    if x.device.type == "cpu":
        return w8a8_dense_plain(x, wq, wscale, bias, act)
    _check_args(x, wq, wscale, bias, act)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"w8a8_dense: unsupported device {dev}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("w8a8_dense: x must be a contiguous f32 [M, K] tensor")
    if wq.dtype != torch.int8 or not wq.is_contiguous():
        raise ValueError("w8a8_dense: wq must be a contiguous int8 [N, >= K] tensor")
    for name, t in (("wscale", wscale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"w8a8_dense: {name} must be contiguous f32")
    for t in (wq, wscale, bias):
        if t is not None and t.device != dev:
            raise ValueError("w8a8_dense: all tensors must be on one device")
    m, k = x.shape
    n = wq.shape[0]
    if k > MAX_K:
        raise ValueError(f"w8a8_dense: K = {k} exceeds the kernel's {MAX_K}")
    if m > 65535 * 64:
        raise ValueError(f"w8a8_dense: M = {m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = kernels.library("w8a8_dense")
    _bind(lib)
    rc = lib.hps_w8a8_dense(
        dev.index, kernels.stream_of(x), x.data_ptr(), wq.data_ptr(),
        wscale.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), m, n, k, wq.shape[1], _ACT_CODE[act],
        int(k % 4 == 0 and x.data_ptr() % 16 == 0),
        int(wq.shape[1] % 16 == 0 and wq.data_ptr() % 16 == 0),
    )
    kernels.check(lib, rc, "w8a8_dense")
    kernels.launches["w8a8_dense"] += 1
    return out
