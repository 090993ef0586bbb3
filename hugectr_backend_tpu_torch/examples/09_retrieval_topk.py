"""Two-tower retrieval: user tower + full-corpus scoring + top-k on the card.

The item corpus IS the resident (int8-quantized) embedding table. A
retrieve runs the user-embedding gather (K1, ``csrc/gather_dequant.cu``,
once per retrieve), the query-tower MLP, a [B, N] product against the
corpus (the dequant scales fold into a columnwise multiply) and the top-k on
the card, in ``lax.top_k``'s order (ties by index); only the winners reach
the host.

    python -m hugectr_backend_tpu_torch.examples.09_retrieval_topk [--device cpu]
"""

import numpy as np
import torch

from hugectr_backend_tpu_torch import HierParameterServer
from hugectr_backend_tpu_torch.examples._common import check, cli, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.models import TwoTowerUser
from hugectr_backend_tpu_torch.serving.retrieval import RetrievalServer

DIM, N_USERS, N_ITEMS, K = 32, 10_000, 50_000, 10


def main(device=None, root=None, state=None) -> dict:
    """``state``: {"two_tower": the user tower's state dict}."""
    state = state or {}
    with workdir(root, "hps_example_") as root:
        users = make_synthetic_table(N_USERS, DIM, seed=1)
        items = make_synthetic_table(N_ITEMS, DIM, seed=2)
        write_sparse_model(root / "users", users.keys, users.vectors)
        write_sparse_model(root / "items", items.keys, items.vectors)
        ps = HierParameterServer.create({"models": [{
            "model": "retrieval",
            "sparse_files": [str(root / "users"), str(root / "items")],
            "embedding_vecsize_per_table": [DIM, DIM],
            "maxnum_catfeature_query_per_table_per_sample": [1, 1],
            "gpucacheper": 1.0,
            "embedding_cache_type": "static",
            "quant_bits": 8,
        }]}, device=device)
        try:
            b, nd = 8, 4
            model = TwoTowerUser(nd, 1, DIM, widths=(64, DIM))
            if "two_tower" in state:
                model.load_state_dict(state["two_tower"])
            else:
                model.init_flax_(torch.Generator().manual_seed(0))
            srv = RetrievalServer(ps.get_model_params("retrieval"),
                                  ps.get_embedding_cache("retrieval", 0),
                                  model, user_table=0, item_table=1, k=K)
            rng = np.random.default_rng(0)
            ukeys = users.keys[rng.integers(0, N_USERS, b)]
            dense = rng.standard_normal((b, nd)).astype(np.float32)
            item_keys, scores = srv.retrieve(ukeys, dense)
            item_keys, scores = np.asarray(item_keys), np.asarray(scores)
            where = srv.cache.device
        finally:
            ps.shutdown()
    print(f"retrieved top-{K} of {N_ITEMS} items for {b} users (int8 corpus, on {where})")
    print("user", int(ukeys[0]), "-> items", item_keys[0][:5].tolist(),
          "scores", np.round(scores[0][:5], 4).tolist())
    check(item_keys.shape == scores.shape == (b, K), f"shapes {item_keys.shape}, {scores.shape}")
    check((np.diff(scores, axis=1) <= 1e-6).all(), "scores are not in descending order")
    print("ok")
    return {"user_keys": ukeys, "dense": dense, "item_keys": item_keys, "scores": scores}


if __name__ == "__main__":
    cli(main, __doc__)
