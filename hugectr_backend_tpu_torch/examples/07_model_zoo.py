"""Model zoo tour — every fused dense family served behind the same lookup
engine (the reference serves these via HPS -> TF/TRT Triton ensembles,
samples/hps-triton-ensemble/README.md; here each predict is one lookup and
the model's forward on the card, with no host round trip between them).

Families: WDL, DeepFM, DCN-v2, xDeepFM and NCF through
``serving.program``'s ``make_*_server``, each one K1 launch
(``csrc/gather_dequant.cu``, every table of the predict) and the model in
PyTorch; BST (the behavior-sequence transformer) through the DIN serving
path, ``serving.pooled.FusedDinServer``: two K1 launches (the target and the
sequence). DLRM has its own example (02_fused_dlrm_serving).

    python -m hugectr_backend_tpu_torch.examples.07_model_zoo [--device cpu]
"""

import numpy as np
import torch

from hugectr_backend_tpu_torch import HierParameterServer
from hugectr_backend_tpu_torch.examples._common import check, cli, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.models import BST, NCF, DCNv2, DeepFM, WideAndDeep, XDeepFM
from hugectr_backend_tpu_torch.serving.pooled import FusedDinServer
from hugectr_backend_tpu_torch.serving.program import (
    make_dcn_server,
    make_deepfm_server,
    make_ncf_server,
    make_wdl_server,
    make_xdeepfm_server,
)

B, ND = 8, 13


def _init(model, name: str, state: dict):
    if name in state:
        model.load_state_dict(state[name])
        return model
    return model.init_flax_(torch.Generator().manual_seed(0))


def main(device=None, root=None, state=None) -> dict:
    """``state``: {"wdl", "deepfm", "dcn_v2", "xdeepfm", "ncf", "bst"} state
    dicts."""
    state = state or {}
    out = {}
    with workdir(root, "hps_zoo_") as root:
        rng = np.random.default_rng(0)
        # One shared deployment: a vecsize-1 "wide/first-order" table and two
        # vecsize-16 feature tables.
        wide = make_synthetic_table(5_000, 1, seed=1)
        feat_a = make_synthetic_table(20_000, 16, seed=2)
        feat_b = make_synthetic_table(30_000, 16, seed=3)
        for name, tbl in [("wide", wide), ("a", feat_a), ("b", feat_b)]:
            write_sparse_model(root / name, tbl.keys, tbl.vectors)

        def model_cfg(name, files, dims, kps):
            return {"model": name, "sparse_files": [str(root / f) for f in files],
                    "embedding_vecsize_per_table": dims,
                    "maxnum_catfeature_query_per_table_per_sample": kps,
                    "gpucacheper": 1.0, "embedding_cache_type": "static"}

        ps = HierParameterServer.create({"models": [
            model_cfg("pair", ["wide", "a"], [1, 16], [4, 4]),        # WDL, DeepFM
            model_cfg("stack", ["a", "b"], [16, 16], [2, 3]),         # DCN-v2, xDeepFM
            model_cfg("two_tower", ["a", "b"], [16, 16], [1, 1]),     # NCF, BST
        ]}, device=device)
        try:
            def served(name):
                return ps.get_model_params(name), ps.get_embedding_cache(name, 0)

            def show(name, logits):
                logits = logits.cpu().numpy()
                print(f"{name:8s} logits[:4] = {logits[:4].round(4)}")
                check(logits.shape == (B,) and np.isfinite(logits).all(),
                      f"{name} logits {logits.shape}, finite {np.isfinite(logits).all()}")
                out[name] = logits

            dense = rng.standard_normal((B, ND)).astype(np.float32)
            wkeys = wide.keys[rng.integers(0, 5_000, (B, 4))]
            akeys = feat_a.keys[rng.integers(0, 20_000, (B, 4))]

            # --- WDL --------------------------------------------------------
            model = _init(WideAndDeep(ND, 4, 16, deep_widths=(64, 1)), "wdl", state)
            show("WDL", make_wdl_server(*served("pair"), model).predict([wkeys, akeys], dense))

            # --- DeepFM (first-order table + shared second-order embeddings)
            model = _init(DeepFM(ND, 4, 16, deep_widths=(64, 1)), "deepfm", state)
            show("DeepFM", make_deepfm_server(*served("pair"), model).predict(
                [wkeys, akeys], dense))

            # --- DCN-v2 / xDeepFM over stacked equal-dim tables -------------
            skeys = [feat_a.keys[rng.integers(0, 20_000, (B, 2))],
                     feat_b.keys[rng.integers(0, 30_000, (B, 3))]]
            model = _init(DCNv2(ND, 5, 16, num_cross_layers=2, cross_rank=16,
                                deep_widths=(64,), head_widths=(32, 1)), "dcn_v2", state)
            show("DCN-v2", make_dcn_server(*served("stack"), model).predict(skeys, dense))
            model = _init(XDeepFM(ND, 5, 16, cin_feature_maps=(16, 8), deep_widths=(64, 1)),
                          "xdeepfm", state)
            show("xDeepFM", make_xdeepfm_server(*served("stack"), model).predict(skeys, dense))

            # --- NCF (two-tower user/item) ----------------------------------
            ukeys = feat_a.keys[rng.integers(0, 20_000, (B, 1))]
            ikeys = feat_b.keys[rng.integers(0, 30_000, (B, 1))]
            model = _init(NCF(0, 16, mlp_widths=(64, 32)), "ncf", state)
            show("NCF", make_ncf_server(*served("two_tower"), model).predict(
                [ukeys, ikeys], np.zeros((B, 0), np.float32)))

            # --- BST (behavior-sequence transformer over the DIN serving path)
            tkeys = feat_b.keys[rng.integers(0, 30_000, B)]
            hkeys = feat_b.keys[rng.integers(0, 30_000, (B, 6))]
            seq_len = rng.integers(0, 7, B).astype(np.int32)
            model = _init(BST(ND, 16, 6, num_heads=4, num_layers=1, head_widths=(32, 1)),
                          "bst", state)
            srv = FusedDinServer(*served("two_tower"), model, target_table=1, seq_table=1)
            show("BST", srv.predict(tkeys, hkeys, seq_len, dense))
        finally:
            ps.shutdown()
    print("model zoo OK — six families served through one lookup engine")
    return out


if __name__ == "__main__":
    cli(main, __doc__)
