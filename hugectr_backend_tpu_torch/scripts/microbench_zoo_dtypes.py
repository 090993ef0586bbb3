"""The zoo's dense halves at f32 and at bf16: the models alone, and their products.

DCN-v2 (BASELINE config 3 at the JAX defaults over the 26 Criteo tables:
width 13 + 26 x 128 = 3,341, batch 4096) and BST (4 heads, 1 layer, head
256-64-1; batch 1024, S 64, D 128), as chip_smoke's ``zoo`` phase serves
them, on embeddings drawn from a seed (no lookup). Per model:

- the forward at f32 (TF32 off), and four bf16 variants on the same
  weights: ``bf16`` and ``bf16_f32_sums`` compute each product as the port
  did before its bf16 products were repaired (``F.linear`` with the bias
  added to the sum before the one rounding, a bf16 ``torch.matmul``), under
  PyTorch's default, which lets cuBLAS add a split-K product's partial sums
  in bf16 (``allow_bf16_reduced_precision_reduction``), and with that
  switched off; ``bf16_f32_out`` is the port as it serves now
  (``models.dlrm.matmul_f32_sums``: the f32 SGEMM of the bf16 operands,
  rounded once to bf16, then the bias in bf16, as the JAX package computes
  it); ``bf16_mm_out_dtype`` is the same arithmetic on the tensor cores,
  ``torch.mm`` / ``torch.bmm`` with ``out_dtype=torch.float32``
  (:func:`mm_out_dtype`; the card only: those overloads have no CPU
  kernel). Per variant: device time per forward (CUDA-graph replay), the
  kernels by name (``torch.profiler``), and the output's max |delta| / max
  |logit| against the f32 forward;
- each product of the forward alone at its shape (``F.linear`` or the
  attention's batched ``matmul``) in the same five variants.

The bound of a product: max(bytes / memory rate, 2MKN / peak rate of its
type), each operand read once and the output written once.

    python -m hugectr_backend_tpu_torch.scripts.microbench_zoo_dtypes [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from hugectr_backend_tpu_torch.scripts.common import card_info, graph_us, peaks
from hugectr_backend_tpu_torch.tiers.hbm import default_device

NUM_DENSE, TABLES, DIM = 13, 26, 128
DCN_BATCH, BST_BATCH, SEQ = 4096, 1024, 64
N_SETS = 2
SEED = 2026


#: (variant, compute dtype, cuBLAS's reduced-precision bf16 reductions, the
#: form of the bf16 products: "port" as the port computes them, "before" as
#: it did before the repair, "mm_out_dtype" on the tensor cores)
VARIANTS = (("f32", torch.float32, True, "port"), ("bf16", torch.bfloat16, True, "before"),
            ("bf16_f32_sums", torch.bfloat16, False, "before"),
            ("bf16_f32_out", torch.bfloat16, True, "port"),
            ("bf16_mm_out_dtype", torch.bfloat16, True, "mm_out_dtype"))


@contextlib.contextmanager
def reduced_bf16_sums(on: bool):
    """cuBLAS's reduced-precision bf16 reductions ``on`` or off for the block."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = on
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


def mm_out_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``models.dlrm.matmul_f32_sums`` on the tensor cores: ``torch.mm`` /
    ``torch.bmm`` with ``out_dtype=torch.float32`` (f32 sums whatever
    ``allow_bf16_reduced_precision_reduction`` says), rounded once. The card
    only; timed and checked here, used nowhere in the port."""
    if a.dim() == 2 and b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32).to(a.dtype)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32).to(a.dtype)
    return out.view(*lead, *out.shape[-2:])


#: The model modules that call ``dense`` or ``matmul_f32_sums`` by the name
#: they import (every family's): :func:`product_forms` swaps the name in each
#: that has it; a module that calls them under another name is not swapped.
MODEL_MODULES = ("dlrm", "dcn", "bst", "mmoe", "xdeepfm", "ncf")


def dense_before_repair(x, layer, mixed_precision=False, weight=None,
                        compute_dtype=torch.float32):
    """``models.dlrm.dense`` as the port had it before its bf16 products
    were repaired: below f32 the input, weight and bias in that type and
    one ``F.linear``, so the bias is added to the sum before the one
    rounding. Kept for the measurement and the test of that repair."""
    from hugectr_backend_tpu_torch.models.quant_dense import linear

    w = layer.weight if weight is None else weight
    if compute_dtype != torch.float32:
        return F.linear(x.to(compute_dtype), w.to(compute_dtype), layer.bias.to(compute_dtype))
    if mixed_precision:
        return linear(x, w, mixed_precision=True) + layer.bias
    return F.linear(x, w, layer.bias)


@contextlib.contextmanager
def product_forms(form: str):
    """The models' bf16 products in ``form`` for the block: "port" as the
    port computes them; "before": ``dense`` and ``matmul_f32_sums``
    replaced in every module of MODEL_MODULES by their forms before the
    repair; "mm_out_dtype": ``matmul_f32_sums`` replaced by
    :func:`mm_out_dtype`."""
    import importlib

    swaps = {"port": {},
             "before": {"dense": dense_before_repair, "matmul_f32_sums": torch.matmul},
             "mm_out_dtype": {"matmul_f32_sums": mm_out_dtype}}[form]
    saved = []
    for name in MODEL_MODULES:
        module = importlib.import_module(f"hugectr_backend_tpu_torch.models.{name}")
        if not hasattr(module, "dense"):
            raise AttributeError(f"models.{name} no longer imports dense by name")
        for attr, fn in swaps.items():
            if hasattr(module, attr):
                saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, fn)
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def models(dcn_batch: int, bst_batch: int, seq: int, device):
    """-> [(name, constructor of a compute dtype, input sets)], inputs drawn
    from SEED: dense N(0, 1), embeddings N(0, 0.1) (a lookup's scale),
    seq_len uniform in [1, seq]."""
    from hugectr_backend_tpu_torch.models import BST, DCNv2

    g = torch.Generator().manual_seed(SEED)

    def draw(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    dcn_sets = [(draw(dcn_batch, NUM_DENSE), draw(dcn_batch, TABLES, DIM, std=0.1))
                for _ in range(N_SETS)]
    bst_sets = [(draw(bst_batch, NUM_DENSE), draw(bst_batch, DIM, std=0.1),
                 draw(bst_batch, seq, DIM, std=0.1),
                 torch.randint(1, seq + 1, (bst_batch,), generator=g).to(device))
                for _ in range(N_SETS)]
    return [
        ("dcn_v2", lambda cd: DCNv2(NUM_DENSE, TABLES, DIM, compute_dtype=cd), dcn_sets),
        ("bst", lambda cd: BST(NUM_DENSE, DIM, seq, num_heads=4, num_layers=1,
                               head_widths=(256, 64, 1), compute_dtype=cd), bst_sets),
    ]


def products(name: str, batch: int, seq: int) -> list:
    """The forward's products: ("linear", M, K, N) or ("bmm", batches, M, K, N)."""
    if name == "dcn_v2":
        w = NUM_DENSE + TABLES * DIM
        return [("linear", batch, w, 64), ("linear", batch, 64, w), ("linear", batch, w, 1024),
                ("linear", batch, 1024, 512), ("linear", batch, 512, 256),
                ("linear", batch, w + 256, 128), ("linear", batch, 128, 1)]
    t, heads = seq + 1, 4
    dk = DIM // heads
    return [("linear", batch * t, DIM, DIM), ("linear", batch * t, DIM, 4 * DIM),
            ("linear", batch * t, 4 * DIM, DIM), ("bmm", batch * heads, t, dk, t),
            ("bmm", batch * heads, t, t, dk), ("linear", batch, DIM + NUM_DENSE, 256),
            ("linear", batch, 256, 64), ("linear", batch, 64, 1)]


def _profile(run, n: int) -> list:
    """[(kernel, ms per call)] of the device kernels of ``run()``, which
    makes ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            name = e.name[:80]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sorted(((k, v / n) for k, v in by_name.items()), key=lambda kv: -kv[1])[:6]


def _product_call(spec, dtype, form, device, g):
    from hugectr_backend_tpu_torch.models.dlrm import matmul_f32_sums

    kind, *dims = spec
    mm = {"port": matmul_f32_sums, "mm_out_dtype": mm_out_dtype}.get(form)
    if dtype == torch.float32 or form == "before":
        mm = None
    if kind == "linear":
        m, k, n = dims
        x = torch.randn(m, k, generator=g).to(device, dtype)
        w = torch.randn(n, k, generator=g).to(device, dtype)
        b = torch.randn(n, generator=g).to(device, dtype)
        call = (lambda: F.linear(x, w, b)) if mm is None else (lambda: mm(x, w.T) + b)
        return call, 2.0 * m * k * n, (m * k + n * k + n + m * n)
    nb, m, k, n = dims
    a = torch.randn(nb, m, k, generator=g).to(device, dtype)
    c = torch.randn(nb, k, n, generator=g).to(device, dtype)
    call = (lambda: torch.matmul(a, c)) if mm is None else (lambda: mm(a, c))
    return call, 2.0 * nb * m * k * n, nb * (m * k + k * n + m * n)


def run(device=None, dcn_batch: int = DCN_BATCH, bst_batch: int = BST_BATCH,
        seq: int = SEQ, emit=None) -> list:
    """Forward each model in each variant, time it and its products on a
    card; on the CPU only the outputs are compared. -> the result lines."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    info = card_info(dev)
    rates = peaks(info["card"]) if timed else None
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    emit = emit or _print
    batches = {"dcn_v2": dcn_batch, "bst": bst_batch}
    for name, make, sets in models(dcn_batch, bst_batch, seq, dev):
        f32 = make(torch.float32).init_flax_(torch.Generator().manual_seed(SEED)).to(dev).eval()
        bf16 = make(torch.bfloat16).to(dev).eval()
        bf16.load_state_dict(f32.state_dict())
        with torch.inference_mode():
            want = f32(*sets[0])
            for variant, dtype, on, form in VARIANTS:
                if form == "mm_out_dtype" and not timed:
                    continue  # no CPU kernel
                model = f32 if dtype == torch.float32 else bf16
                with reduced_bf16_sums(on), product_forms(form):
                    got = model(*sets[0])
                    line = {"bench": "microbench_zoo_dtypes", "model": name,
                            "batch": batches[name], "variant": variant,
                            "reduced_bf16_sums": on, "products": form,
                            "rel_vs_f32": float((got.float() - want).abs().max()
                                                / want.abs().max()),
                            "device": info["device"]}
                    if timed:
                        calls = [lambda s=s: model(*s) for s in sets]
                        line["us"] = graph_us(calls)
                        line["top_kernels_ms"] = _profile(lambda: [c() for c in calls],
                                                          len(calls))
                out.append(line)
                emit(line)
        if not timed:
            continue
        g = torch.Generator().manual_seed(SEED + 1)
        for spec in products(name, batches[name], seq):
            line = {"bench": "microbench_zoo_dtypes", "model": name, "product": list(spec),
                    "device": info["device"]}
            for variant, dtype, on, form in VARIANTS:
                call, ops, elems = _product_call(spec, dtype, form, dev, g)
                with reduced_bf16_sums(on), torch.inference_mode():
                    us = graph_us([call])
                size = 4 if dtype == torch.float32 else 2
                peak = rates[3] if dtype == torch.float32 else rates[1]
                bound = max(elems * size / rates[0], ops / peak) * 1e6
                line[f"{variant}_us"] = us
                line[f"{variant}_bound_us"] = bound
                line[f"{variant}_tflops"] = ops / us / 1e6
            out.append(line)
            emit(line)
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
