"""The fused DLRM's dense half at batch 4096, stage by stage, against the
card's published peaks.

Port of the JAX package's ``scripts/microbench_dense.py``. The DLRM of
``bench.py`` (bottom MLP 13 -> 512 -> 256 -> 128, the dot interaction over
27 features, top MLP 479 -> 1024 -> 1024 -> 512 -> 256 -> 1) on the
benchmark's feature layout: the 14 one-hot Criteo tables folded into the
interaction (K3, from a ``gen_flat`` arena with host scales) and 12 fed
features (the arena's 4 as one part, the 8 solo tables one part each):

    A  the full dense forward, f32 (K3; cuBLAS SGEMMs with TF32 off)
    B  the same, ``compute_dtype=bf16`` (bf16 GEMMs, K3 on bf16)
    C  int8 weight-only dense layers (f32 products of the dequantized weights)
    D  fp8 weight-only
    H  w8a8 (K5 in all 8 layers)
    E  the bottom MLP alone (f32)
    F  the interaction alone, bf16 (as the JAX script) and f32: K4 on the
       stacked [B, 26, D], K2 on the parts, and ``bmm`` + triu gather
    G  the top MLP alone (f32)

FLOP accounting (the JAX script's, MACs x 2 a sample): bottom 13*512 +
512*256 + 256*128 = 170,496 MACs; the interaction 27^2 * 128 = 93,312; top
479*1024 + 1024^2 + 1024*512 + 512*256 + 256 = 2,194,688; in all 2,458,496
MACs = 4.92 MFLOP a sample, 20.1 GFLOP a batch of 4096. Each stage's line
has its time (``common.graph_us``: ``N_SETS`` input sets captured in one
CUDA graph and replayed), its FLOP and bytes (weights, inputs and output
once), the achieved rate, and its floor against the H100's published peaks
(``common.PEAKS``: 67 TFLOP/s f32 outside the tensor cores, 989 bf16, 1,979
int8, 3.35 TB/s) for the stage's type, with the card's name and power limit.
The full forwards' lines also name the kernels their device time goes to
(``common.device_profile``, eager launches of the first input set).
Correctness: each full forward's first 64 logits against the same model on
the CPU (``bench.VARIANT_TOL``), each interaction variant against the plain
K4.

    python -m hugectr_backend_tpu_torch.scripts.microbench_dense [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch import bench
from hugectr_backend_tpu_torch.ops.fused_interaction import (
    EmbParts,
    dot_interaction_parts,
    fused_dot_interaction,
    fused_dot_interaction_ref,
)
from hugectr_backend_tpu_torch.scripts.common import (
    card_info,
    device_profile,
    flat_truth,
    graph_us,
    peaks,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

BATCH, T, DIM, ND = 4096, 26, 128, 13
N_SETS = 4
F_FEATS = T + 1
INTER_OUT = DIM + F_FEATS * (F_FEATS - 1) // 2  # 479
MACS = {
    "bottom": ND * 512 + 512 * 256 + 256 * DIM,
    "interaction": F_FEATS * F_FEATS * DIM,
    "top": INTER_OUT * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1,
}
MACS["total"] = sum(MACS.values())
#: The full forwards: (stage, bench variant, the peak the products run at).
FULL = (("A_full_f32", "f32", "f32"), ("B_full_bf16cast", "bf16cast", "bf16"),
        ("C_full_int8", "int8", "f32"), ("D_full_fp8", "fp8", "f32"),
        ("H_full_w8a8", "w8a8", "int8"))


class Inputs:
    """One input set: dense [B, 13], the one-hot group (arena, slots [14, B],
    host scales) and the 12 fed features as parts; and their stacked
    [B, 26, D] f32 form (the K4 and CPU reference input)."""

    def __init__(self, tables: "bench.CriteoTables", batch: int, seed: int, device):
        r = np.random.default_rng(seed)
        n_oh = len(tables.oh_cards)
        _, ar, big = bench.grouping(bench.CRITEO_CARDS)
        self.dense = torch.from_numpy(r.standard_normal((batch, ND)).astype(np.float32)).to(device)
        oh = bench.make_slots(seed, tables.oh_cards, tables.oh_off, batch)
        self.slots = torch.from_numpy(oh.astype(np.int32)).view(n_oh, batch).to(device)
        self.scales = torch.from_numpy(bench.host_scale(oh)).view(n_oh, batch).to(device)
        n_ar, n_big = len(ar), len(big)
        fed = (r.standard_normal((n_ar + n_big, batch, DIM)) * 0.1).astype(np.float32)
        self.fed = torch.from_numpy(fed).to(device)
        self.parts = [self.fed[:n_ar]] + [self.fed[n_ar + j:n_ar + j + 1] for j in range(n_big)]
        self.fmap = [(0, j) for j in range(n_ar)] + [(1 + j, 0) for j in range(n_big)]
        self.oh = (tables.oh_vals, self.slots, self.scales, tables.oh_members)
        truth = flat_truth(oh, "device").reshape(n_oh, batch, DIM)
        self.stacked = torch.cat([torch.from_numpy(truth).to(device), self.fed]).transpose(0, 1)

    def emb(self) -> EmbParts:
        return EmbParts(self.parts, self.fmap, self.dense.shape[0], oh=self.oh)


def onehot_tables(device) -> "bench.CriteoTables":
    """The arena of the 14 one-hot Criteo tables alone (the fed features are
    random: the solo tables would take 4.3 GB)."""
    oh, _, _ = bench.grouping(bench.CRITEO_CARDS)
    return bench.CriteoTables([bench.CRITEO_CARDS[t] for t in oh], device)


def weight_bytes(model) -> int:
    return sum(b.numel() * b.element_size() for b in model.state_dict().values())


def run(device=None, batch: int = BATCH, emit=None) -> list:
    """Check every stage, and time it on a card. -> the result lines."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    if timed:
        torch.backends.cuda.matmul.allow_tf32 = False
    info = card_info(dev)
    bw, bf16, int8, f32 = peaks(info["card"]) if timed else (None,) * 4
    peak = {"f32": f32, "bf16": bf16, "int8": int8}
    tables = onehot_tables(dev)
    sets = [Inputs(tables, batch, s, dev) for s in range(N_SETS)]
    base = bench.make_model(T)
    variants = bench.make_variants(base)
    n_ref = min(bench.N_REF, batch)
    out = []

    def put(line):
        line = {"bench": "microbench_dense", "batch": batch, **line, "device": info["device"]}
        out.append(line)
        (emit or _print)(line)

    def stage(name, calls, flop, nbytes, kind, profile=False, **extra):
        line = {"stage": name, "flop": flop, "bytes": nbytes, "peak": kind, **extra}
        if timed:
            if profile:
                _, top = device_profile(lambda: [calls[0]() for _ in range(5)], 5)
                line["top_device_kernels_us"] = [(k, ms * 1e3) for k, ms in top[:8]]
            us = graph_us(calls)
            floor = max(flop / peak[kind], nbytes / bw) * 1e6
            line.update({"us": us, "tflop_per_s": flop / us / 1e6, "floor_us": floor,
                         "floor_by": "operations" if flop / peak[kind] >= nbytes / bw
                         else "bytes", "pct_of_floor": 100 * floor / us})
        put(line)

    emb_bytes = batch * T * DIM * 4
    with torch.inference_mode():
        ref_in = sets[0]
        for name, variant, kind in FULL:
            model = variants[variant][0]
            want = model(ref_in.dense[:n_ref].cpu(), ref_in.stacked[:n_ref].cpu()).float().numpy()
            m = model.to(dev)
            got = m(ref_in.dense, ref_in.emb()).float()[:n_ref].cpu().numpy()
            rel = bench.rel_err(got, want)
            if rel > bench.VARIANT_TOL[variant]:
                raise AssertionError(f"microbench_dense {name}: vs the CPU {rel}")
            stage(name, [lambda s=s, m=m: m(s.dense, s.emb()) for s in sets],
                  2 * MACS["total"] * batch,
                  weight_bytes(m) + batch * ND * 4 + emb_bytes + batch * 4, kind,
                  profile=True, cpu_rel=rel)
        f32m = variants["f32"][0]
        stage("E_bottom", [lambda s=s: f32m.bottom(s.dense) for s in sets],
              2 * MACS["bottom"] * batch,
              weight_bytes(f32m.bottom) + batch * ND * 4 + batch * DIM * 4, "f32")
        xs = [torch.randn(batch, INTER_OUT, generator=torch.Generator().manual_seed(s)).to(dev)
              for s in range(N_SETS)]
        stage("G_top", [lambda x=x: f32m.top(x) for x in xs], 2 * MACS["top"] * batch,
              weight_bytes(f32m.top) + batch * INTER_OUT * 4 + batch * 4, "f32")
        for dt in (torch.bfloat16, torch.float32):  # z is bf16 either way: the bf16 peak
            es = torch.finfo(dt).bits // 8
            ins = [(s.stacked[:, 0].to(dt).contiguous(), s.stacked.to(dt).contiguous())
                   for s in sets]
            ref = fused_dot_interaction_ref(*ins[0])
            rows, cols = torch.triu_indices(F_FEATS, F_FEATS, 1, device=dev)
            flop = 2 * MACS["interaction"] * batch
            nbytes = batch * F_FEATS * DIM * es + batch * INTER_OUT * es
            tag = str(dt).replace("torch.", "")

            def bmm_triu(bottom, emb):
                z = torch.cat([bottom[:, None], emb], 1).to(torch.bfloat16).float()
                zzt = torch.bmm(z, z.transpose(1, 2))
                return torch.cat([bottom, zzt[:, rows, cols].to(bottom.dtype)], 1)

            fns = {"K4": fused_dot_interaction,
                   "K2": lambda bottom, emb: dot_interaction_parts(
                       bottom, [emb.transpose(0, 1)], tuple((0, t) for t in range(T))),
                   "bmm_triu": bmm_triu}
            for name, fn in fns.items():
                got = fn(*ins[0])
                err = float((got.float() - ref.float()).abs().max())
                tol = float(ref.float().abs().max()) * (2.0 ** -7 if dt == torch.bfloat16
                                                        else 1e-5)
                if got.dtype != dt or err > tol:
                    raise AssertionError(f"microbench_dense F {name} {tag}: err {err}")
                stage(f"F_interaction_{name}_{tag}", [lambda a=a, fn=fn: fn(*a) for a in ins],
                      flop, nbytes, "bf16", max_abs_err_vs_plain_k4=err)
    gflop = 2 * MACS["total"] * batch / 1e9
    summary = {"summary": "FLOP accounting", "macs_per_sample": MACS,
               "flop_per_batch_g": gflop}
    if timed:
        summary.update({"bf16_floor_us": gflop * 1e9 / bf16 * 1e6,
                        "int8_floor_us": gflop * 1e9 / int8 * 1e6,
                        "f32_floor_us": gflop * 1e9 / f32 * 1e6})
    put(summary)
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
