"""Serve a full Triton model repository: HPS sparse model + torch dense model
+ ensemble DAG — the reference's hps-triton-ensemble deployment
(reference samples/hps-triton-ensemble/02_model_inference_hps_tf_ensemble.ipynb
and HPS_Pytorch_ensemble_deployment.ipynb).

Flow: train-side torch MLP -> TorchScript -> converted to the native dense
format by ``python -m hugectr_backend_tpu_torch.tools.convert_dense_model``
-> config.pbtxt files -> ``serve(model_repository=...)`` -> KServe infer
against the ensemble. The hps -> dense chain runs fused on the card: one
lookup (K1, ``csrc/gather_dequant.cu``, f32 rows: ``quant_bits`` 32) whose
output stays on the card for the dense model's f32 layers, with no host
round trip between the two "backends".

    python -m hugectr_backend_tpu_torch.examples.05_triton_repo_ensemble [--device cpu]
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from hugectr_backend_tpu_torch.examples._common import check, cli, post_json, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.serving.server import serve
from hugectr_backend_tpu_torch.tiers.hbm import default_device

REPO_ROOT = Path(__file__).resolve().parents[2]
DIM, KEYS_PER_SAMPLE = 16, 4
RTOL, ATOL = 1e-4, 1e-5  # the ensemble against the torch MLP (f32 sums in another order)

HPS_CONFIG = """
name: "hps_embedding"
backend: "hps"
input [
  { name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] },
  { name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }
]
output [ { name: "OUTPUT0" data_type: TYPE_FP32 dims: [ -1 ] } ]
instance_group [ { count: 1 kind: KIND_GPU gpus: [ 0 ] } ]
"""

DENSE_CONFIG = """
name: "dense_model"
platform: "pytorch_libtorch"
input [ { name: "input_1" data_type: TYPE_FP32 dims: [ -1 ] } ]
output [ { name: "output_1" data_type: TYPE_FP32 dims: [ -1, 1 ] } ]
"""

ENSEMBLE_CONFIG = """
name: "ensemble_model"
platform: "ensemble"
input [
  { name: "EMB_KEY" data_type: TYPE_INT64 dims: [ -1, -1 ] },
  { name: "EMB_N_KEY" data_type: TYPE_INT32 dims: [ -1, -1 ] }
]
output [ { name: "DENSE_OUTPUT" data_type: TYPE_FP32 dims: [-1, 1] } ]
ensemble_scheduling {
  step [
    { model_name: "hps_embedding" model_version: -1
      input_map { key: "KEYS" value: "EMB_KEY" }
      input_map { key: "NUMKEYS" value: "EMB_N_KEY" }
      output_map { key: "OUTPUT0" value: "LOOKUP_VECTORS" } },
    { model_name: "dense_model" model_version: -1
      input_map { key: "input_1" value: "LOOKUP_VECTORS" }
      output_map { key: "output_1" value: "DENSE_OUTPUT" } }
  ]
}
"""


def make_mlp(state=None) -> torch.nn.Sequential:
    """The train-side torch MLP: 64 -> 32 -> 1, torch's default init drawn
    under ``torch.manual_seed(0)`` (the global generator is restored), or
    ``state``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mlp = torch.nn.Sequential(
            torch.nn.Linear(DIM * KEYS_PER_SAMPLE, 32), torch.nn.ReLU(),
            torch.nn.Linear(32, 1), torch.nn.Sigmoid(),
        )
    if state is not None:
        mlp.load_state_dict(state)
    return mlp.eval()


def main(device=None, root=None, state=None) -> dict:
    """``state``: {"mlp": the torch MLP's state dict}."""
    dev = default_device(device)  # raises with no card unless "cpu"
    with workdir(root, "hps_ensemble_repo_") as root:
        # 1. Sparse half: HPS model dir (config.pbtxt + version dir with sparse files).
        mdir = root / "hps_embedding"
        mdir.mkdir()
        (mdir / "config.pbtxt").write_text(HPS_CONFIG)
        tbl = make_synthetic_table(5000, DIM, seed=42)
        write_sparse_model(mdir / "1" / "emb.model", tbl.keys, tbl.vectors)

        # 2. Dense half: a torch MLP, TorchScript'd like the reference's
        #    sample, then converted to the native dense format (the tool
        #    checks the written model against the MLP on the same device).
        mlp = make_mlp((state or {}).get("mlp"))
        ddir = root / "dense_model"
        (ddir / "1").mkdir(parents=True)
        torch.jit.save(torch.jit.script(mlp), str(ddir / "1" / "model.pt"))
        (ddir / "config.pbtxt").write_text(DENSE_CONFIG)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run(
            [sys.executable, "-m", "hugectr_backend_tpu_torch.tools.convert_dense_model",
             str(ddir / "1" / "model.pt"), str(ddir / "1"),
             "--reshape", "-1", str(DIM * KEYS_PER_SAMPLE), "--device", str(dev)],
            check=True, env=env, timeout=600,
        )

        # 3. Ensemble DAG wiring the two (same config shape as the reference sample).
        edir = root / "ensemble_model"
        (edir / "1").mkdir(parents=True)
        (edir / "config.pbtxt").write_text(ENSEMBLE_CONFIG)

        # 4. ps.json at the repo root (full static cache -> the fused path engages).
        (root / "ps.json").write_text(json.dumps({"models": [{
            "model": "hps_embedding",
            "sparse_files": ["emb.model"],
            "embedding_vecsize_per_table": [DIM],
            "maxnum_catfeature_query_per_table_per_sample": [KEYS_PER_SAMPLE],
            "max_batch_size": 64,
            "gpucacheper": 1.0,
            "embedding_cache_type": "static",
            "quant_bits": 32,
        }]}))

        # 5. Serve the repository and infer against the ensemble.
        server = serve(model_repository=root, port=0, block=False, device=device)
        try:
            b = 3
            keys = tbl.keys[: b * KEYS_PER_SAMPLE].astype(np.int64)
            resp = post_json(server.port, "/v2/models/ensemble_model/infer", {"inputs": [
                {"name": "EMB_KEY", "datatype": "INT64",
                 "shape": [b * KEYS_PER_SAMPLE], "data": keys.tolist()},
                {"name": "EMB_N_KEY", "datatype": "INT32", "shape": [1],
                 "data": [b * KEYS_PER_SAMPLE]},
            ]})
        finally:
            server.stop()
    out = np.asarray(resp["outputs"][0]["data"], np.float32).reshape(b, 1)
    x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
    with torch.no_grad():
        want = mlp(torch.from_numpy(x)).numpy()
    print("ensemble predictions:", out.ravel())
    print("torch ground truth:  ", want.ravel())
    check(np.allclose(out, want, rtol=RTOL, atol=ATOL),
          f"the ensemble's {out.ravel()} against the torch MLP's {want.ravel()}")
    print(f"OK: the fused ensemble on {dev} matches the torch reference")
    return {"keys": keys, "output": out, "torch_output": want}


if __name__ == "__main__":
    cli(main, __doc__)
