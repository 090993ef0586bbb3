"""Table sharding AS A CONFIG ACTION: ps.json ``shard_tables`` deploys every
table row-sharded over the mesh, served through the standard stack
(ModelManager -> continuous batcher -> HTTP front end) — the replacement for
the reference's Redis-cluster ``num_partitions`` capacity partitioning
(reference docs/hierarchical_parameter_server.md:435-444).

One 100,000 x 32 int8 table over ``--shards`` mesh entries (default 8,
``deployed_device_list`` 0..N-1), strategy all_to_all. With as many cards as
entries, entry d lives on ``cuda:d``; with fewer, every entry is pinned to
``cuda:0`` (``ModelManager.create(..., device="cuda:0")``), so the entries
share one card, their exchange is copies within it, and no interconnect is
measured. Kernels: K1 (``csrc/gather_dequant.cu``) once per device per
lookup, over every shard that device holds.

    python -m hugectr_backend_tpu_torch.examples.04_sharded_multichip [--shards 8] [--device cpu]
"""

import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.examples._common import (
    check,
    cli,
    keys_request,
    post_json,
    workdir,
)
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer
from hugectr_backend_tpu_torch.tiers.hbm import default_device


def placement(device, shards: int):
    """-> (the ``device`` argument for ``ModelManager.create``, whether the
    entries share one device)."""
    dev = default_device(device)  # raises with no card unless "cpu"
    if device is None and torch.cuda.device_count() >= shards:
        return None, False
    return (str(dev), True) if shards > 1 else (str(dev), False)


def main(device=None, root=None, state=None, shards: int = 8) -> dict:
    place, shared = placement(device, shards)
    with workdir(root, "hps_example_") as root:
        dim = 32
        table = make_synthetic_table(100_000, dim, seed=0)
        write_sparse_model(root / "emb0", table.keys, table.vectors)

        # The whole deployment is this config — no sharding code on the user side.
        ps_json = {"models": [{
            "model": "dlrm",
            "sparse_files": [str(root / "emb0")],
            "embedding_vecsize_per_table": [dim],
            "maxnum_catfeature_query_per_table_per_sample": [4],
            "gpucacheper": 1.0,
            "embedding_cache_type": "static",
            "quant_bits": 8,
            "shard_tables": True,                        # <- the feature
            "deployed_device_list": list(range(shards)),  # the mesh
            "shard_strategy": "all_to_all",
        }]}
        mgr = ModelManager.create(json.dumps(ps_json), device=place)
        cache = mgr.ps.get_embedding_cache("dlrm", 0)
        per_shard = sum(t.nbytes_per_shard() for t in cache.tables) / 1e6
        where = (f"the {shards} entries share {place}: their exchange is copies within "
                 "it, no interconnect is measured" if shared else
                 f"one entry per card, cuda:0..cuda:{shards - 1}")
        print(f"table: {table.num_rows} rows x {dim}d int8, {per_shard:.1f} MB per shard "
              f"across {shards} shards (strategy={cache.strategy}); {where}")

        # Serve over the KServe HTTP front end like any other model.
        server = HpsHttpServer(mgr, port=0).start()
        try:
            q = table.keys[np.random.default_rng(0).integers(0, table.num_rows, 64)]
            resp = post_json(server.port, "/v2/models/dlrm/infer", keys_request(q))
        finally:
            server.stop()
    out = np.asarray(resp["outputs"][0]["data"], np.float32).reshape(-1, dim)
    err = float(np.abs(out - expected_vector(q, dim)).max())
    print(f"HTTP lookup of {len(q)} keys through the sharded path: max int8 error {err:.5f}")
    # Rows of sin values lie in [-1, 1]: an int8 row is within half a step
    # (max|row| / 254) of its f32 row.
    check(err <= 1 / 254 + 1e-6, f"int8 error {err} past half a quantization step")
    return {"shards": shards, "shared_device": shared, "per_shard_mb": per_shard,
            "strategy": cache.strategy, "keys": q, "output": out, "max_err": err}


def _flags(ap):
    ap.add_argument("--shards", type=int, default=8, help="mesh entries (deployed devices)")


if __name__ == "__main__":
    cli(main, __doc__, _flags)
