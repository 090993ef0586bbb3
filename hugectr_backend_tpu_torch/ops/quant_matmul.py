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
tensors. The kernel takes any M, N and K up to :data:`MAX_K` (its int32
sums' exact range): there are no alignment gates. :func:`k5_plan`
chooses, per layer shape, which of the kernel's paths runs (a GEMV; a
narrow kernel that quantizes its own rows; or a quantize kernel and a
product on mma.sync or wgmma) and how it is launched; the kernel refuses a plan it does not take. The layer has no
backward: under autograd it raises rather than return a result cut from the
graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

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

#: The largest K the kernel takes: its int32 sums, like the reference's int32
#: dot, are exact while 127 * 127 * K < 2^31 (past it a sum could wrap). The
#: quantize kernel and the products stream K in chunks; device memory bounds
#: nothing below this K that x [M, K] itself does not.
MAX_K = 133144
#: The largest K of the GEMV (N <= 8): it keeps up to 8 weight rows of K
#: bytes (rounded up to 128) in a block's shared memory, 232,448 bytes. Past
#: it N <= 8 goes to the mma.sync product after the quantize kernel.
GEMV_MAX_K = 29056

#: The H100's streaming multiprocessors and the dynamic shared memory one
#: block may use (bytes): what :func:`k5_plan` sizes its grids and tiles for.
H100_SMS = 132
MAX_SMEM = 232448
#: Dynamic shared memory that keeps a second CTA off an SM (an H100 SM has
#: 233,472 bytes, 1 KB of it reserved per block).
_ONE_PER_SM = 116736

# Constants of csrc/w8a8_dense.cu the plans depend on.
_THREADS, _WARPS = 256, 8
_BK, _BS_LD, _WBK = 64, 80, 128
_GEMV_MAX_N = 8
_NARROW_BM, _NARROW_MAX_K = 16, 512
#: The mma.sync product's output tiles (rows, columns per CTA) after the
#: quantize kernel, larger first, on an 8-stage ring; for K <= 64 the 64 x 128
#: tile quantizes its own rows from a 4-stage ring.
TILES = ((64, 128), (32, 64))
_TILE_STAGES = 8
_VARIANT_CODE = {"gemv": 0, "narrow": 1, "tile": 2, "wgmma": 3}

_bound = False


class K5Plan(NamedTuple):
    """How K5 runs one layer, ``threads`` per CTA throughout:

    - "gemv" (N <= 8): one kernel, a warp per row; ``grid`` (CTAs, 1).
    - "narrow" (K <= 512): one kernel; ``grid`` (CTAs, 1), a multiple of the
      ``bn``-column slices of the weight, each CTA keeping its slice in
      shared memory and walking items of ``bm`` rows.
    - "tile" / "wgmma": a quantize kernel of ``qgrid`` CTAs (none for "tile"
      with K <= 64: the product quantizes its own rows), then a product on
      mma.sync / wgmma with a CTA per ``bm`` x ``bn`` output tile, ``grid``
      = (row tiles, column tiles), streaming K through a ring of ``stages``
      chunks.

    ``smem``: bytes of dynamic shared memory per CTA of the GEMV, the narrow
    kernel or the product: what it uses, or for a product after the
    quantize kernel with at most one CTA per SM more, so that its CTAs
    spread one to an SM."""

    variant: str
    bm: int
    bn: int
    stages: int
    grid: tuple
    qgrid: int
    threads: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemv_kq(k: int) -> int:
    for kq in (128, 256, 512, 1024):
        if k <= kq:
            return kq
    return _cdiv(k, 128) * 128


def quant_kq(k: int) -> int:
    """The row stride of the quantized activations: K padded to 64 bytes."""
    return _cdiv(k, _BK) * _BK


def narrow_smem(bn: int, k: int) -> int:
    """Shared memory of the narrow kernel: the weight slice and the item's
    quantized rows (rows K padded to 64, plus 16 bytes), the f32 output
    rows, then xs, wscale and bias."""
    ld = quant_kq(k) + 16
    return (bn + _NARROW_BM) * ld + _NARROW_BM * (bn + 4) * 4 + (_NARROW_BM + 2 * bn) * 4


def tile_smem(bm: int, bn: int, stages: int) -> int:
    """Shared memory of the mma.sync product: the cp.async ring (chunks of
    64 bytes of K), overlaid by the f32 output tile, then the tile's xs,
    wscale and bias."""
    return max(stages * (bm + bn) * _BS_LD, bm * (bn + 4) * 4) + (bm + 2 * bn) * 4


def wg_smem(bm: int, stages: int) -> int:
    """Shared memory of the wgmma product: 1 KB of slack that aligns the
    swizzle, the ring (chunks of 128 bytes of K) overlaid by the f32 output
    tile, then the tile's xs, wscale and bias."""
    return 1024 + max(stages * (bm + 128) * _WBK, bm * (128 + 4) * 4) + (bm + 256) * 4


def k5_plan(m: int, n: int, k: int, sms: int = H100_SMS, wvec: bool = True) -> K5Plan:
    """The launch plan of K5 for x [m, k] and a weight [n, >= k] (``wvec``:
    its rows a multiple of 16 bytes, 16-byte aligned) on a card of ``sms``
    SMs. Each choice is the fastest measured at the DLRM's layer shapes at
    M = 4096 on an H100 (PERF.md):

    - N <= 8 and K <= GEMV_MAX_K: "gemv", a warp per row, 8 rows per CTA.
    - K <= 64: "tile", 64 x 128 tiles quantizing their own rows.
    - ``wvec``, K > 256 and N >= 256: "wgmma", 128 x 128 tiles on a 3-stage
      ring where there are at least ``sms`` of them, else 64 x 128 (4
      stages for K <= 512, else 3).
    - K <= 512: "narrow", up to four CTAs per SM, items of 16 rows,
      128-column slices where that still gives every CTA an item, else 64.
    - N <= 8 past GEMV_MAX_K: "tile" after the quantize kernel, 32 x 64
      tiles (twice the CTAs of 64 x 128, which measured slower there).
    - else "tile" after the quantize kernel: 64 x 128 tiles where the grid
      holds at least ``sms`` / 3 CTAs, else 32 x 64."""
    if m < 1 or n < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"k5_plan: no plan for M {m}, N {n}, K {k} (1 <= K <= {MAX_K})")
    if n <= _GEMV_MAX_N:
        if k <= GEMV_MAX_K:
            return K5Plan("gemv", _WARPS, n, 0, (min(_cdiv(m, _WARPS), 1 << 20), 1), 0,
                          _THREADS, n * _gemv_kq(k))
        return _tile_plan(m, n, k, *TILES[-1], sms=sms)
    if k <= _BK:
        return _tile_plan(m, n, k, 64, 128, 4)
    if wvec and k > 256 and n >= 256:
        bm = 128 if _cdiv(m, 128) * _cdiv(n, 128) >= sms else 64
        return _wgmma_plan(m, n, k, bm, 4 if bm == 64 and k <= 512 else 3, sms)
    if k <= _NARROW_MAX_K:
        ctas = 4 * sms
        bn = 128 if _cdiv(m, _NARROW_BM) * _cdiv(n, 128) >= ctas else 64
        return _narrow_plan(m, n, k, bn, ctas)
    bm, bn = TILES[0] if 3 * _cdiv(m, 64) * _cdiv(n, 128) >= sms else TILES[-1]
    return _tile_plan(m, n, k, bm, bn, sms=sms)


def _product_smem(smem: int, ctas: int, sms: int) -> int:
    """The shared memory a product after the quantize kernel asks for: where
    its grid has at most one CTA per SM, enough that no SM takes two, so
    that its CTAs spread over the SMs as the quantize kernel's drain (two
    to an SM measured 2 µs slower at 512 -> 256, PERF.md)."""
    return max(smem, _ONE_PER_SM) if ctas <= sms else smem


def _narrow_plan(m: int, n: int, k: int, bn: int, ctas: int) -> K5Plan:
    """The narrow kernel with ``bn``-column slices on at most ``ctas`` CTAs
    (at least one per slice)."""
    slices = _cdiv(n, bn)
    grid = slices * min(_cdiv(m, _NARROW_BM), max(1, ctas // slices))
    return K5Plan("narrow", _NARROW_BM, bn, 0, (grid, 1), 0, _THREADS, narrow_smem(bn, k))


def _tile_plan(m: int, n: int, k: int, bm: int, bn: int, stages: int = _TILE_STAGES,
               sms: int = H100_SMS) -> K5Plan:
    """The mma.sync product; ``stages`` 4: the 64 x 128 tile that quantizes
    its own rows (K <= 64)."""
    if stages == 4 and k > _BK:
        raise ValueError(f"k5_plan: the in-product quantize takes K <= {_BK}, not {k}")
    if _cdiv(n, bn) > 65535:
        raise ValueError(f"k5_plan: N = {n} needs more than 65535 column tiles")
    grid = (_cdiv(m, bm), _cdiv(n, bn))
    smem = tile_smem(bm, bn, stages)
    if stages == 4:
        return K5Plan("tile", bm, bn, stages, grid, 0, _THREADS, smem)
    return K5Plan("tile", bm, bn, stages, grid, _cdiv(m, _WARPS), _THREADS,
                  _product_smem(smem, grid[0] * grid[1], sms))


def _wgmma_plan(m: int, n: int, k: int, bm: int, stages: int, sms: int = H100_SMS) -> K5Plan:
    if _cdiv(n, 128) > 65535:
        raise ValueError(f"k5_plan: N = {n} needs more than 65535 column tiles")
    grid = (_cdiv(m, bm), _cdiv(n, 128))
    return K5Plan("wgmma", bm, 128, stages, grid, _cdiv(m, _WARPS), _THREADS,
                  _product_smem(wg_smem(bm, stages), grid[0] * grid[1], sms))


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
    lib.hps_w8a8_dense.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    _bound = True


def launch_plan(x: torch.Tensor, wq: torch.Tensor) -> K5Plan:
    """The plan :func:`w8a8_dense` launches for CUDA operands ``x`` [M, K]
    and ``wq`` [N, >= K]: :func:`k5_plan` with the card's SM count."""
    (m, k), n = x.shape, wq.shape[0]
    return k5_plan(m, n, k, torch.cuda.get_device_properties(x.device).multi_processor_count,
                   _wvec(wq))


def _wvec(wq: torch.Tensor) -> bool:
    return wq.shape[1] % 16 == 0 and wq.data_ptr() % 16 == 0


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
    return _launch(x, wq, wscale, bias, act, None)


def _launch(x, wq, wscale, bias, act, plan: Optional[K5Plan]) -> torch.Tensor:
    """The kernel on CUDA operands with :func:`launch_plan`'s plan, or with
    ``plan`` (a timing sweep's; the kernel checks it)."""
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
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    plan = launch_plan(x, wq) if plan is None else plan
    lib = kernels.library("w8a8_dense")
    _bind(lib)
    # The quantize kernel's output: xq [M, Kq] int8, then xs [M] f32.
    scratch = (torch.empty(m * quant_kq(k) + 4 * m, dtype=torch.int8, device=dev)
               if plan.qgrid > 0 else None)
    rc = lib.hps_w8a8_dense(
        dev.index, kernels.stream_of(x), x.data_ptr(), wq.data_ptr(),
        wscale.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), m, n, k, wq.shape[1], _ACT_CODE[act],
        int(k % 4 == 0 and x.data_ptr() % 16 == 0),
        int(_wvec(wq)), _VARIANT_CODE[plan.variant], plan.bm, plan.bn, plan.stages, *plan.grid,
        plan.qgrid, plan.smem,
        None if scratch is None else scratch.data_ptr(),
    )
    kernels.check(lib, rc, "w8a8_dense")
    kernels.count_launch("w8a8_dense")
    return out
