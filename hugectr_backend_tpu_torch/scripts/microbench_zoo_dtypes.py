"""The zoo's dense halves at f32 and at bf16: the models alone, and their products.

DCN-v2 (BASELINE config 3 at the JAX defaults over the 26 Criteo tables:
width 13 + 26 x 128 = 3,341, batch 4096) and BST (4 heads, 1 layer, head
256-64-1; batch 1024, S 64, D 128), as chip_smoke's ``zoo`` phase serves
them, on embeddings drawn from a seed (no lookup). Per model:

- the forward at f32 (TF32 off), at ``compute_dtype`` bf16 as the port
  serves it (PyTorch's default, which lets cuBLAS add a split-K product's
  partial sums in bf16: ``allow_bf16_reduced_precision_reduction``), and at
  bf16 with that switched off, so that every product sums in f32 as the
  JAX package's do (``bf16_f32_sums``): device time per forward (CUDA-graph
  replay), the kernels by name (``torch.profiler``), and the output's max
  |delta| / max |logit| against the f32 forward;
- each product of the forward alone at its shape (``F.linear`` or the
  attention's batched ``matmul``) in the same three variants.

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


#: (variant, compute dtype, cuBLAS's reduced-precision bf16 reductions)
VARIANTS = (("f32", torch.float32, True), ("bf16", torch.bfloat16, True),
            ("bf16_f32_sums", torch.bfloat16, False))


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


def _product_call(spec, dtype, device, g):
    kind, *dims = spec
    if kind == "linear":
        m, k, n = dims
        x = torch.randn(m, k, generator=g).to(device, dtype)
        w = torch.randn(n, k, generator=g).to(device, dtype)
        b = torch.randn(n, generator=g).to(device, dtype)
        return lambda: F.linear(x, w, b), 2.0 * m * k * n, (m * k + n * k + n + m * n)
    nb, m, k, n = dims
    a = torch.randn(nb, m, k, generator=g).to(device, dtype)
    c = torch.randn(nb, k, n, generator=g).to(device, dtype)
    return lambda: torch.matmul(a, c), 2.0 * nb * m * k * n, nb * (m * k + k * n + m * n)


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
            for variant, dtype, on in VARIANTS:
                model = f32 if dtype == torch.float32 else bf16
                with reduced_bf16_sums(on):
                    got = model(*sets[0])
                    line = {"bench": "microbench_zoo_dtypes", "model": name,
                            "batch": batches[name], "variant": variant,
                            "reduced_bf16_sums": on,
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
            for variant, dtype, on in VARIANTS:
                call, ops, elems = _product_call(spec, dtype, dev, g)
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
