"""Deploy a model and serve lookups — the reference's
`Hierarchical_Parameter_Server_Deployment.ipynb` flow, self-contained.

Writes a 10,000 x 16 table in the HPS binary format, deploys it from a
ps.json (a dynamic cache holding half the rows on the card, int8) through
``ModelManager``, serves it over KServe-v2 HTTP (``HpsHttpServer``) and asks
for 52 keys. Kernels: K1 (gather + dequant, ``csrc/gather_dequant.cu``) once
per lookup.

    python -m hugectr_backend_tpu_torch.examples.01_deploy_and_lookup [--device cpu]
"""

import json
import urllib.request

import numpy as np

from hugectr_backend_tpu_torch.examples._common import (
    check,
    cli,
    keys_request,
    post_json,
    workdir,
)
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer


def main(device=None, root=None, state=None) -> dict:
    with workdir(root, "hps_example_") as root:
        # 1. "Training" writes the sparse model in the HPS binary format.
        table = make_synthetic_table(10_000, 16, seed=0)
        write_sparse_model(root / "dlrm_table0", table.keys, table.vectors)

        # 2. ps.json — same schema as the reference's.
        ps_json = {
            "supportlonglong": True,
            "models": [{
                "model": "dlrm",
                "sparse_files": [str(root / "dlrm_table0")],
                "embedding_vecsize_per_table": [16],
                "maxnum_catfeature_query_per_table_per_sample": [26],
                "max_batch_size": 1024,
                "gpucache": True,
                "gpucacheper": 0.5,
                "hit_rate_threshold": 0.9,
                "embedding_cache_type": "dynamic",
                "quant_bits": 8,
            }],
        }

        # 3. Serve (the `tritonserver --backend-config=hps,ps=...` equivalent).
        manager = ModelManager.create(json.dumps(ps_json), device=device)
        server = HpsHttpServer(manager, port=0).start()
        try:
            print(f"serving on port {server.port}")
            # 4. Health check + inference, as the reference notebooks do
            # with curl / tritonclient.
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/v2/health/ready") as r:
                ready = r.status
            print("ready:", ready)
            check(ready == 200, f"/v2/health/ready answered {ready}")

            batch = 2
            keys = table.keys[: 26 * batch]
            resp = post_json(server.port, "/v2/models/dlrm/infer", keys_request(keys))
        finally:
            server.stop()
    out = np.asarray(resp["outputs"][0]["data"], np.float32).reshape(-1, 16)
    num_sample = resp["parameters"]["NumSample"]
    print("NumSample:", num_sample, "output:", out.shape)
    print("first vector:", out[0][:4], "...")
    check(num_sample == batch and out.shape == (26 * batch, 16),
          f"NumSample {num_sample}, output {out.shape}")
    return {"ready": ready, "num_sample": num_sample, "keys": keys, "output": out}


if __name__ == "__main__":
    cli(main, __doc__)
