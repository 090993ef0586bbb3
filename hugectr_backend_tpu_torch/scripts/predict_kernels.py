"""Time the kernels of one Criteo predict in a given source tree, so that two
trees can be held against each other in one call on one card.

    python3 hugectr_backend_tpu_torch/scripts/predict_kernels.py [--tree DIR]
        [--microbench] [--out FILE]

It imports the port and ``chip_smoke.py`` from ``DIR`` (default: the tree
that holds this script), builds ``chip_smoke``'s deployment (the 26 capped
Criteo tables, batch 4096), records the kernel calls of one fold predict
(K1 + K3) and one K2-path predict (``HPS_OH_IN_KERNEL=0``: K1 + K2), and
prints one JSON line per measurement:

- ``k1``: each path's K1 launches (one per group, or one for all groups,
  whichever the tree makes) chained in one CUDA graph, their count, and the
  groups' ``index_select`` calls chained the same way (the library
  yardstick);
- ``interaction``: K3 and K2 at their recorded inputs and K4 on the same
  features stacked (CUDA-graph replay);
- ``w8a8_dense``: K5 at the 8 layer shapes of one w8a8 predict (their
  recorded inputs), each layer's plan and the 8 chained in one CUDA graph;
- ``backward``: the interaction's backward kernel at the training shape
  (B 4096, 26 features, D 128, random inputs from a seed), its plan;
- ``predict``: the device kernel time of a predict (``torch.profiler``) and
  its wall time, f32 and w8a8, fold and K2 path;
- with ``--microbench``: the tree's ``microbench_onehot`` lines (K6 v2 at
  every m_tile, v1, K1 on the same slots) and ``microbench_true`` lines
  (configs A-J).

Every line carries the tree, the card's name and its power limit. It needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the source tree to time (its root)")
    ap.add_argument("--microbench", action="store_true",
                    help="also run microbench_onehot and microbench_true")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("predict_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import hugectr_backend_tpu_torch.cache.lookup_program as lp
    import hugectr_backend_tpu_torch.models.dlrm as dl
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.ops import quant_matmul as qm
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        bwd_plan,
        fused_dot_interaction,
        fused_dot_interaction_bwd,
        k3_plan,
    )
    from hugectr_backend_tpu_torch.scripts.common import graph_us
    from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    head = {"tree": tree, "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    def emit(line):
        text = json.dumps({**line, **head})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    cards = [min(c, cs.ROW_CAP) for c in cs.CRITEO_CARDS]
    with tempfile.TemporaryDirectory(prefix="hps_predict_kernels_") as root:
        tables, cfg = cs.build_deployment(root, cards, cs.DIM, cs.SEED)
        ps = HierParameterServer.create(cfg)
    cache = ps.get_embedding_cache("dlrm", 0)
    batches = cs.make_batches(tables, cs.BATCH, 3, cs.SEED + 1)
    servers = {"f32": make_dlrm_multi_server(ps.get_model_params("dlrm"), cache,
                                             cs.make_model(len(cards), cs.SEED)),
               "w8a8": make_dlrm_multi_server(ps.get_model_params("dlrm"), cache,
                                              cs.make_model(len(cards), cs.SEED, "w8a8"))}

    # Record the K1 and interaction calls of one predict on each path.
    names = [(lp, n) for n in ("gather_dequant", "gather_dequant_groups") if hasattr(lp, n)]
    names += [(dl, "dot_interaction_oh_parts"), (dl, "dot_interaction_parts")]

    def record(path):
        calls, orig = [], {}
        for mod, n in names:
            orig[(mod, n)] = getattr(mod, n)

            def rec(*a, _o=orig[(mod, n)], _n=n):
                calls.append((_n, _o, a))
                return _o(*a)

            setattr(mod, n, rec)
        if path == "k2":
            os.environ["HPS_OH_IN_KERNEL"] = "0"
        try:
            cs.predict_sync(servers["f32"], *batches[0])
        finally:
            os.environ.pop("HPS_OH_IN_KERNEL", None)
            for (mod, n), o in orig.items():
                setattr(mod, n, o)
        return calls

    for path in ("fold", "k2"):
        calls = record(path)
        k1 = [(fn, a) for n, fn, a in calls if n.startswith("gather_dequant")]
        chain = [lambda fn=fn, a=a: fn(*a) for fn, a in k1]
        idx = []
        for n, fn, a in calls:
            if n == "gather_dequant":
                idx.append((a[0], a[2].long()))
            elif n == "gather_dequant_groups":
                vals, _, slots_cat, _, meta, sb, _ = a
                idx += [(v, slots_cat[lo:hi].long()) for v, m, (lo, hi) in zip(vals, meta, sb)
                        if m[0] != "skip"]
        emit({"k1": path, "launches": len(k1), "chained_us": graph_us(chain) * len(chain),
              "index_select_chained_us": graph_us(
                  [lambda: [torch.index_select(v, 0, i) for v, i in idx]] * 20)})
        (n, fn, a), = [c for c in calls if c[0].startswith("dot_interaction")]
        feats = 1 + len(a[2]) if n == "dot_interaction_parts" else 1 + a[2].shape[0] + len(a[5])
        emit({"interaction": n, "plan": k3_plan(cs.BATCH, feats, cs.DIM)._asdict(),
              "us": graph_us([lambda: fn(*a)] * 20)})
        if path == "fold":
            continue
        bottom, parts, fmap = a
        emb = torch.stack([parts[p][s][:bottom.shape[0]] for p, s in fmap], dim=1)
        with torch.no_grad():
            emit({"interaction": "fused_dot_interaction",
                  "us": graph_us([lambda: fused_dot_interaction(bottom, emb)] * 20)})

    # K5 at the w8a8 predict's 8 layer shapes; the backward at the training
    # shape.
    with cs.Recorder() as rec:
        cs.predict_sync(servers["w8a8"], *batches[0])
    layers = rec.calls["w8a8_dense"]
    for a in layers:
        emit({"w8a8_dense": [tuple(a[0].shape), tuple(a[1].shape)],
              "plan": qm.launch_plan(a[0], a[1])._asdict(),
              "us": graph_us([lambda a=a: qm.w8a8_dense(*a)] * 20)})
    chain = [lambda a=a: qm.w8a8_dense(*a) for a in layers]
    emit({"w8a8_dense": "the layers back to back", "layers": len(layers),
          "chained_us": graph_us(chain) * len(chain)})
    gen = torch.Generator().manual_seed(cs.SEED)
    bottom = torch.randn(cs.BATCH, cs.DIM, generator=gen).to("cuda")
    emb = torch.randn(cs.BATCH, len(cards), cs.DIM, generator=gen).to("cuda")
    f = len(cards) + 1
    g_out = torch.randn(cs.BATCH, cs.DIM + f * (f - 1) // 2, generator=gen).to("cuda")
    emit({"backward": [cs.BATCH, f, cs.DIM],
          "plan": bwd_plan(cs.BATCH, cs.DIM, len(cards))._asdict(),
          "us": graph_us([lambda: fused_dot_interaction_bwd(bottom, emb, g_out)] * 20)})

    for fmt, srv in servers.items():
        for path in ("fold", "k2"):
            if path == "k2":
                os.environ["HPS_OH_IN_KERNEL"] = "0"
            for bt in batches:
                cs.predict_sync(srv, *bt)
            walls = []
            for i in range(10):
                t0 = time.perf_counter()
                cs.predict_sync(srv, *batches[i % len(batches)])
                walls.append((time.perf_counter() - t0) * 1e3)
            busy, top = cs.predict_profile(srv, batches)
            os.environ.pop("HPS_OH_IN_KERNEL", None)
            walls.sort()
            med = walls[len(walls) // 2]
            emit({"predict": f"{fmt} {path}", "wall_median_ms": med, "device_kernel_ms": busy,
                  "device_idle_share": None if busy is None else 1 - busy / med,
                  "top_device_kernels_ms": top[:4]})
    if args.microbench:
        del servers, cache, ps
        torch.cuda.empty_cache()
        from hugectr_backend_tpu_torch.scripts import microbench_onehot, microbench_true

        for mb in (microbench_onehot, microbench_true):
            mb.run("cuda", emit=lambda line: emit(line) if "us_per_batch" in line else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
