"""One w8a8 dense layer: K5 against the plain formulation, per layer shape.

Port of the JAX package's ``scripts/microbench_w8a8_kernel.py`` (its Pallas
kernel against XLA's formulation). Here K5 (``ops/quant_matmul.w8a8_dense``:
the activations quantized per row, the int8 product, the rescale, the bias
and relu in one kernel) against the port's plain formulation of the same
function, the counterpart of ``xla_w8a8``: ``quantize_activations``, then
``torch._int_mm`` (K and N zero-padded to multiples of 8, as it requires),
then the rescale, the bias and relu, each its own pass. At batch 4096, the
JAX script's shapes (``SHAPES``) and the fused DLRM's 8 layers
(``DLRM_LAYERS``, the eligible-layer ladder: every layer of the serving
DLRM runs K5), the top layer's K = 479 with its weight rows zero-padded to
480 (the serving path's layout, ``serving/program.py _permute_columns``)
and, beside it, unpadded: the raw weight handed to K5 as it is
(``dlrm_layer_unpadded``), and a w8a8 ``QuantDense`` holding it as stored,
called directly (``quant_dense_unpadded``: the layer pads its rows for K5,
``models/quant_dense.py``). Per shape: K5's launch
plan, both times (``common.graph_us``, ``N_SETS`` activation sets a graph),
the bound max(bytes / memory rate, 2MKN / int8 rate) with what bounds it,
and the ratios. The correctness step: both outputs equal K5's plain
version (``w8a8_dense_plain``) bit for bit.

The weights are the JAX script's (``numpy.random.default_rng(0)``: int8 in
[-127, 127], scales in [0.001, 0.021), biases in [0, 0.1)), stored [N, K].
The activations: ``sin(0.37 col + 0.011 row + set)``.

    python -m hugectr_backend_tpu_torch.scripts.microbench_w8a8_kernel [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from hugectr_backend_tpu_torch.models.quant_dense import QuantDense
from hugectr_backend_tpu_torch.ops.quant_matmul import (
    launch_plan,
    quantize_activations,
    w8a8_dense,
    w8a8_dense_plain,
)
from hugectr_backend_tpu_torch.scripts.common import card_info, graph_us, peaks
from hugectr_backend_tpu_torch.tiers.hbm import default_device

BATCH = 4096
SHAPES = [(512, 256), (256, 128), (1024, 1024), (1024, 512)]  # (K, N), the JAX script's
DLRM_LAYERS = [(13, 512), (512, 256), (256, 128), (479, 1024), (1024, 1024), (1024, 512),
               (512, 256), (256, 1)]
N_SETS = 4


def weights(rng, k: int, n: int, device, pad16: bool = False):
    """The JAX script's draws for one (K, N): -> (wq [N, K] int8, ws [N], b
    [N]); ``pad16``: wq's rows zero-padded to a multiple of 16 columns."""
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = rng.random(n, np.float32) * 0.02 + 0.001
    b = rng.random(n, np.float32) * 0.1
    wt = np.zeros((n, -(-k // 16) * 16 if pad16 else k), np.int8)
    wt[:, :k] = wq.T
    return (torch.from_numpy(wt).to(device), torch.from_numpy(ws).to(device),
            torch.from_numpy(b).to(device))


def activations(k: int, batch: int, s: int, device) -> torch.Tensor:
    col = torch.arange(k, dtype=torch.float32, device=device)[None, :]
    row = torch.arange(batch, dtype=torch.float32, device=device)[:, None]
    return torch.sin(col * 0.37 + row * 0.011 + float(s))


def _up8(n: int) -> int:
    return -(-n // 8) * 8


class IntMmW8a8:
    """The plain formulation over one layer's weights: the weight padded
    once to [N8, K8] (its transpose is ``_int_mm``'s right operand)."""

    def __init__(self, wq, ws, b, k: int, act="relu"):
        n = wq.shape[0]
        self.k, self.n, self.ws, self.b, self.act = k, n, ws, b, act
        w = torch.zeros(_up8(n), _up8(k), dtype=torch.int8, device=wq.device)
        w[:n, :k] = wq[:, :k]
        self.wt = w.t()

    def __call__(self, x):
        xq, xs = quantize_activations(x)
        if self.k % 8:
            xq = F.pad(xq, (0, _up8(self.k) - self.k))
        acc = torch._int_mm(xq, self.wt)[:, :self.n]
        y = acc.float() * xs * self.ws + self.b
        return torch.relu(y) if self.act == "relu" else y


def bound(m: int, k: int, n: int, bw: float, int8_ops: float):
    """-> (µs, "bytes" or "operations"): x read (f32), the weights, scales
    and bias read, y written (f32), against the int8 operations."""
    t_bytes = (4 * m * k + k * n + 8 * n + 4 * m * n) / bw * 1e6
    t_ops = 2.0 * m * k * n / int8_ops * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def run(device=None, batch: int = BATCH, shapes=None, emit=None) -> list:
    """Check every shape, and time it on a card. -> the result lines."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    info = card_info(dev)
    rates = peaks(info["card"]) if timed else None
    rng = np.random.default_rng(0)
    out = []
    unaligned = [s for s in DLRM_LAYERS if s[0] % 16]
    todo = ([("jax_script", s) for s in SHAPES] + [("dlrm_layer", s) for s in DLRM_LAYERS]
            + [("dlrm_layer_unpadded", s) for s in unaligned]
            + [("quant_dense_unpadded", s) for s in unaligned])
    for kind, (k, n) in (todo if shapes is None else shapes):
        wq, ws, b = weights(rng, k, n, dev, pad16=kind == "dlrm_layer")
        plain = IntMmW8a8(wq, ws, b, k)
        xs = [activations(k, batch, s, dev) for s in range(N_SETS)]
        want = w8a8_dense_plain(xs[0], wq, ws, b, "relu")
        if kind == "quant_dense_unpadded":
            layer = QuantDense(k, n, "w8a8", activation="relu")
            layer.load_state_dict({"kernel_q": wq, "kernel_scale": ws, "bias": b})
            layer = layer.to(dev)
            k5_call, k5_wq = layer, layer.k5_weight()
        else:
            k5_call, k5_wq = (lambda x: w8a8_dense(x, wq, ws, b, "relu")), wq
        for name, got in (("k5", k5_call(xs[0])), ("int_mm", plain(xs[0]))):
            if not torch.equal(got, want):
                raise AssertionError(f"microbench_w8a8_kernel {k}x{n}: {name} != plain")
        line = {"bench": "microbench_w8a8_kernel", "shape": kind, "m": batch, "k": k, "n": n,
                "weight_row_bytes": wq.shape[1], "k5_weight_row_bytes": k5_wq.shape[1],
                "plan": None if not timed else launch_plan(xs[0], k5_wq)._asdict(),
                "check": "K5 and the _int_mm formulation bit-exact vs w8a8_dense_plain",
                "device": info["device"]}
        if timed:
            k5 = graph_us([lambda x=x: k5_call(x) for x in xs])
            pl = graph_us([lambda x=x: plain(x) for x in xs])
            bnd, by = bound(batch, k, n, rates[0], rates[2])
            line.update({"k5_us": k5, "int_mm_plain_us": pl, "bound_us": bnd, "bound_by": by,
                         "k5_over_bound": k5 / bnd, "plain_over_k5": pl / k5})
        out.append(line)
        (emit or _print)(line)
    return out


def _print(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda[:i] (default) or cpu")
    run(p.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
