"""The AUC-parity evidence: trains a DLRM on synthetic click data, serves the
SAME checkpoint through the serving stack under every lookup and dense
quantization flavor, and reports per-variant AUC and the delta against fp32.

Port of the JAX package's ``scripts/auc_parity.py``, with its variants,
seeds and smoke switch. Two parts:
- ``eval.run_parity``: one table, 26 keys a sample, ``FusedDlrmServer``
  (K1 + K4) in fp32, bf16, fp8, int8, int4 and the int8 tables with int8,
  fp8 and w8a8 dense layers (K5); seeds 0, 1, 2 (smoke: 0);
- ``eval.run_path_parity``: 26 tables (smoke: 4) through
  ``make_dlrm_multi_server`` with the one-hot / arena / solo grouping scaled
  to harness size: fp32 (K1 + K3), int8 and int4 mixed policy with the fold
  off (K2), and the one-hot group folded into K3 (``oh_kernel_engaged``
  says K3 ran); seeds 0, 1 (smoke: 0). The JAX script's
  ``int8_blocked_layout`` leg and its ``kernel_eval_cap`` have no
  counterpart: the port stores tables flat and scores every leg on the whole
  eval set.
Training and serving run on the card unless ``--device cpu``.

    [HPS_AUC_SMOKE=1] python -m hugectr_backend_tpu_torch.scripts.auc_parity \\
        [--device cpu] [--out auc_parity.json]

``HPS_AUC_SMOKE=1`` (the JAX script's switch) is the quick pass. The JSON
goes to standard output, and to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from hugectr_backend_tpu_torch.eval.auc_parity import run_parity, run_path_parity


def configs(smoke: bool):
    """-> (seeds, run_parity's config, run_path_parity's config)."""
    seeds = [0] if smoke else [0, 1, 2]
    cfg = dict(
        n_train=20_000 if smoke else 120_000,
        n_eval=8_000 if smoke else 40_000,
        vocab=1_000 if smoke else 5_000,
        dim=16 if smoke else 32,
        num_feats=26,
        steps=150 if smoke else 600,
    )
    path_cfg = dict(
        n_train=8_000 if smoke else 60_000,
        n_eval=4_000 if smoke else 20_000,
        dim=32 if smoke else 128,
        steps=120 if smoke else 400,
        vocabs=([60, 300, 1500, 3000] if smoke else
                # 26 tables spanning the scaled one-hot (<=512) / arena
                # (<=2048) / solo thresholds — the Criteo mix shape.
                [60, 90, 120, 200, 260, 300, 350, 420, 480, 510,
                 700, 900, 1100, 1300, 1500, 1700, 1900, 2000,
                 2600, 3000, 3400, 3800, 4200, 4600, 5000, 5400]),
    )
    return seeds, cfg, path_cfg


def run(device=None, smoke: bool = False) -> dict:
    seeds, cfg, path_cfg = configs(smoke)
    runs = []
    t0 = time.time()
    for seed in seeds:
        r = run_parity(seed=seed, device=device, **cfg)
        runs.append(r)
        print(f"seed {seed}: " + ", ".join(
            f"{k}={v:.5f}({r['delta_vs_fp32'][k]:+.6f})" for k, v in r["auc"].items()),
            flush=True)
    variants = list(runs[0]["auc"].keys())
    out = {
        "config": cfg,
        "seeds": seeds,
        "device": str(device or "cuda"),
        "auc_per_seed": {v: [r["auc"][v] for r in runs] for v in variants},
        "delta_per_seed": {v: [r["delta_vs_fp32"][v] for r in runs] for v in variants},
        "max_abs_delta": {v: max(abs(r["delta_vs_fp32"][v]) for r in runs)
                          for v in variants},
        "gates": {
            "int8_north_star_lt_0.001": max(
                abs(r["delta_vs_fp32"]["int8"]) for r in runs) < 1e-3,
            "int4_documented_lt_0.01": max(
                abs(r["delta_vs_fp32"]["int4"]) for r in runs) < 1e-2,
        },
        "note": "same trained checkpoint served through "
                "HierParameterServer->EmbeddingCache->FusedDlrmServer per "
                "variant; synthetic click data with embedding-borne signal "
                "(eval/auc_parity.py)",
    }

    path_seeds = seeds[: 1 if smoke else 2]
    path_runs = []
    for seed in path_seeds:
        pr = run_path_parity(seed=seed, device=device, **path_cfg)
        path_runs.append(pr)
        print(f"path seed {seed}: " + ", ".join(
            f"{k}={v:+.6f}" for k, v in pr["delta_vs_fp32"].items()), flush=True)
    paths = list(path_runs[0]["delta_vs_fp32"].keys())
    out["path_parity"] = {
        "config": dict(path_cfg),
        "seeds": path_seeds,
        "auc_per_seed": {p: [r["auc"][p] for r in path_runs] for p in ["fp32"] + paths},
        "delta_per_seed": {p: [r["delta_vs_fp32"][p] for r in path_runs] for p in paths},
        "max_abs_delta": {p: max(abs(r["delta_vs_fp32"][p]) for r in path_runs)
                          for p in paths},
        # Per seed: the one-hot fold (K3) ran in the int8_oh_fold leg.
        "oh_kernel_engaged": [bool(r.get("oh_kernel_engaged")) for r in path_runs],
        "note": "served through make_dlrm_multi_server (mixed lookup kinds, "
                "part-major reorder, one-hot fold); thresholds scaled via env so "
                "all kinds appear",
    }
    out["gates"]["int8_mixed_policy_lt_0.001"] = max(
        abs(r["delta_vs_fp32"]["int8_mixed_policy"]) for r in path_runs) < 1e-3
    out["elapsed_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or a card (default cuda:0)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = run(args.device, smoke=bool(os.environ.get("HPS_AUC_SMOKE")))
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(json.dumps(out["max_abs_delta"], indent=1))
    print("gates:", out["gates"], "->", args.out or "stdout")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
