"""The DLRM dot interaction's formulations at batch 4096, F 27, D 128.

Port of the JAX package's ``scripts/microbench_interaction.py``, which
asked on the TPU whether the triu extraction, not the product, was the
interaction's cost. Its variants, as plain PyTorch on bf16 z with the
products summed in f32 (``preferred_element_type=f32`` there; an f32
``bmm`` of the bf16-rounded z here, TF32 off):

    A  the product alone (no extraction)               — the floor
    B  the product, then ``zzt[:, rows, cols]`` (fancy index)
    C  the product flattened, then ``index_select`` of the flat triu indices
    D  the extraction folded into the next layer: the full symmetric zzt
       (flattened) times an expanded top-layer weight with w/2 at (f, g) and
       (g, f); beside it the unexpanded gather + matmul it replaces
    E  the 26 row runs ``zzt[:, f, f + 1:]`` concatenated (strided slices)

beside the port's kernels on the same z: K4 (``fused_dot_interaction`` on
the stacked [B, 26, D]) and K2 (``dot_interaction_parts`` on the same
features as one part), both with bf16 in and out. Each variant's output is
held against B's (K4 and K2: their pair columns, within a bf16 ulp of B's
rounded to bf16 and the f32 atol of the sums' order), D's against the
gather + matmul it replaces. Times: ``common.graph_us`` (``N_SETS`` z sets
captured in one CUDA graph, replayed).

    python -m hugectr_backend_tpu_torch.scripts.microbench_interaction [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.fused_interaction import (
    dot_interaction_parts,
    fused_dot_interaction,
)
from hugectr_backend_tpu_torch.scripts.common import card_info, graph_us
from hugectr_backend_tpu_torch.tiers.hbm import default_device

BATCH, T, DIM = 4096, 26, 128
F = T + 1
ROWS_NP, COLS_NP = np.triu_indices(F, k=1)
N_INTER = ROWS_NP.size  # 351
TOP_W = 1024
N_SETS = 4


def top_weights():
    """The JAX script's top-layer weight and its expansion over the full
    zzt: -> (w [351, 1024], w_exp [F * F, 1024]), f32 numpy."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((N_INTER, TOP_W)).astype(np.float32) * 0.05
    w_exp = np.zeros((F * F, TOP_W), np.float32)
    w_exp[ROWS_NP * F + COLS_NP] = w / 2
    w_exp[COLS_NP * F + ROWS_NP] = w / 2
    return w, w_exp


def variants(device):
    """-> {name: fn(z bf16 [B, F, D]) -> output}, and the D pair."""
    rows = torch.from_numpy(ROWS_NP).to(device)
    cols = torch.from_numpy(COLS_NP).to(device)
    flat = torch.from_numpy(ROWS_NP * F + COLS_NP).to(device)
    w, w_exp = (torch.from_numpy(a).to(device) for a in top_weights())

    def ein(z):
        zf = z.float()
        return torch.bmm(zf, zf.transpose(1, 2))

    def strided(zzt):
        return torch.cat([zzt[:, f, f + 1:] for f in range(F - 1)], dim=1)

    fns = {
        "A_product_only": ein,
        "B_fancy_index": lambda z: ein(z)[:, rows, cols],
        "C_flat_index_select": lambda z: ein(z).reshape(z.shape[0], F * F).index_select(1, flat),
        "D_fold_matmul": lambda z: ein(z).reshape(z.shape[0], F * F) @ w_exp,
        "D_ref_gather_plus_matmul": lambda z: ein(z)[:, rows, cols] @ w,
        "E_strided_slices": lambda z: strided(ein(z)),
        "K4_bf16": lambda z: fused_dot_interaction(z[:, 0], z[:, 1:]),
        "K2_bf16": lambda z: dot_interaction_parts(z[:, 0], [z[:, 1:].transpose(0, 1)],
                                                   tuple((0, t) for t in range(T))),
    }
    return fns


def z_sets(batch: int, device, n: int = N_SETS):
    """``n`` bf16 z sets [B, F, D] (standard normal, seeds 0..n-1)."""
    return [torch.from_numpy(np.random.default_rng(s).standard_normal((batch, F, DIM))
                             .astype(np.float32)).to(device).to(torch.bfloat16)
            for s in range(n)]


def check(fns, z) -> dict:
    """Each variant against B (K4 / K2: their pair columns), D against its
    reference. -> {name: max |delta|}; raises past the tolerance."""
    b = fns["B_fancy_index"](z)
    scale = float(b.abs().max())
    zm = float(z.float().abs().max())
    errs = {}
    for name, fn in fns.items():
        got = fn(z)
        if name.startswith("A_"):
            got, want, tol = ein_pairs(got), b, 0.0
        elif name.startswith("D_"):
            continue
        elif name.startswith("K"):
            want = b.to(torch.bfloat16).float()
            got = got[:, DIM:].float()
            tol = scale * 2.0 ** -8 + 1e-6 * zm * zm
        else:
            want, tol = b, 0.0
        err = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or err > tol:
            raise AssertionError(f"microbench_interaction {name}: max err {err} > {tol}")
        errs[name] = err
    d, dref = fns["D_fold_matmul"](z), fns["D_ref_gather_plus_matmul"](z)
    err = float((d - dref).abs().max() / (dref.abs().max() + 1e-9))
    if err > 1e-5:
        raise AssertionError(f"microbench_interaction D: fold rel err {err}")
    errs["D_fold_matmul"] = err
    return errs


def ein_pairs(zzt):
    r, c = torch.from_numpy(ROWS_NP).to(zzt.device), torch.from_numpy(COLS_NP).to(zzt.device)
    return zzt[:, r, c]


def run(device=None, batch: int = BATCH, emit=None) -> list:
    """Check every variant, and time it on a card. -> the result lines."""
    dev = default_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    info = card_info(dev)
    fns = variants(dev)
    zs = z_sets(batch, dev)
    with torch.inference_mode():
        errs = check(fns, zs[0])
        out = []
        for name, fn in fns.items():
            line = {"bench": "microbench_interaction", "variant": name, "batch": batch,
                    "features": F, "dim": DIM, "max_err_vs_b": errs.get(name),
                    "device": info["device"]}
            if dev.type == "cuda":
                line["us"] = graph_us([lambda z=z, fn=fn: fn(z) for z in zs])
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
