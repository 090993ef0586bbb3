"""Fused sparse+dense serving — replaces the reference's Triton ensemble
(`02_model_inference_hps_tf_ensemble.ipynb`): the lookup and the dense
forward run on the card back to back, with no host round trip between them.

Two servers:
- ``FusedDlrmServer`` over one 50,000 x 64 int8 table, 26 keys a sample,
  batch 32: K1 (gather + dequant, ``csrc/gather_dequant.cu``) once per
  predict, then the DLRM with K4 (the stacked dot interaction,
  ``csrc/dot_interaction.cu``).
- ``make_dlrm_multi_server`` over one table per categorical feature (6
  tables of 10,000 rows, the Criteo layout): every table in one K1 launch,
  the lookup output handed to the dense graph in chunks (``EmbParts``) and
  the interaction kernel its plan picks (K3 with the one-hot group folded
  in, or K2).
Both DLRMs keep f32 dense layers, so no K5 (w8a8) launch is made here.

    python -m hugectr_backend_tpu_torch.examples.02_fused_dlrm_serving [--device cpu]
"""

import numpy as np
import torch

from hugectr_backend_tpu_torch import HierParameterServer
from hugectr_backend_tpu_torch.examples._common import check, cli, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.models import DLRM
from hugectr_backend_tpu_torch.serving.program import FusedDlrmServer, make_dlrm_multi_server


def _model(num_tables: int, dim: int, seed: int, state):
    model = DLRM(13, num_tables, bottom_widths=(128, dim), top_widths=(128, 1))
    if state is None:
        return model.init_flax_(torch.Generator().manual_seed(seed))
    model.load_state_dict(state)
    return model


def main(device=None, root=None, state=None) -> dict:
    """``state``: {"dlrm": ..., "dlrm_multi": ...} state dicts of the two
    DLRMs."""
    state = state or {}
    with workdir(root, "hps_example_") as root:
        table = make_synthetic_table(50_000, 64, seed=0)
        write_sparse_model(root / "t0", table.keys, table.vectors)
        ps = HierParameterServer.create({"models": [{
            "model": "dlrm",
            "sparse_files": [str(root / "t0")],
            "embedding_vecsize_per_table": [64],
            "maxnum_catfeature_query_per_table_per_sample": [26],
            "gpucacheper": 1.0,
            "embedding_cache_type": "static",
            "quant_bits": 8,
        }]}, device=device)

        batch = 32
        model = _model(26, 64, 0, state.get("dlrm"))
        srv = FusedDlrmServer(ps.get_model_params("dlrm"), ps.get_embedding_cache("dlrm", 0),
                              model)
        rng = np.random.default_rng(0)
        keys = table.keys[rng.integers(0, 50_000, (batch, 26))]
        dense = rng.standard_normal((batch, 13)).astype(np.float32)
        logits = srv.predict(keys, dense).cpu().numpy()
        print("logits:", logits[:8])
        check(logits.shape == (batch,) and np.isfinite(logits).all(),
              f"FusedDlrmServer logits {logits.shape}, finite {np.isfinite(logits).all()}")

        # --- Variant: one table PER categorical feature (the Criteo layout) ---
        ntab, dim = 6, 64
        tabs = [make_synthetic_table(10_000, dim, seed=10 + t) for t in range(ntab)]
        for t, tbl in enumerate(tabs):
            write_sparse_model(root / f"mt{t}", tbl.keys, tbl.vectors)
        ps2 = HierParameterServer.create({"models": [{
            "model": "dlrm_multi",
            "sparse_files": [str(root / f"mt{t}") for t in range(ntab)],
            "embedding_vecsize_per_table": [dim] * ntab,
            "maxnum_catfeature_query_per_table_per_sample": [1] * ntab,
            "gpucacheper": 1.0,
            "embedding_cache_type": "static",
            "quant_bits": 8,
        }]}, device=device)
        model2 = _model(ntab, dim, 1, state.get("dlrm_multi"))
        srv2 = make_dlrm_multi_server(ps2.get_model_params("dlrm_multi"),
                                      ps2.get_embedding_cache("dlrm_multi", 0), model2)
        keys2 = [tabs[t].keys[rng.integers(0, 10_000, (batch, 1))] for t in range(ntab)]
        logits2 = srv2.predict(keys2, dense).cpu().numpy()
        print("multi-table logits:", logits2[:8])
        check(logits2.shape == (batch,) and np.isfinite(logits2).all(),
              f"multi-table logits {logits2.shape}, finite {np.isfinite(logits2).all()}")
        ps.shutdown()
        ps2.shutdown()
    return {"keys": keys, "dense": dense, "logits": logits, "multi_keys": keys2,
            "multi_logits": logits2}


if __name__ == "__main__":
    cli(main, __doc__)
