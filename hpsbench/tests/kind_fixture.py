"""A kind of configuration that exists only for the tests, as a new kind
would come: one module beside ``deploy/hps.py``, registered by the tests as
``hpsbench.deploy.<KIND>`` and named by no entry of ``BENCHMARK.json``.

It serves an HPS model whose tables are the configuration's (multi-hot as
``keys_per_table_per_sample`` gives them) plus one table of weights drawn
from the seed: each sample's dense features (``Request.dense``), cut into
buckets, look up a weight row each. Its judge draws the weights again from
``ctx.seed`` and compares every answer's bytes with the plain reference's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from hpsbench import tables
from hpsbench.deploy import binary_request, hps

KIND = "test_dense_buckets"
#: A feature's bucket is ``floor(2 x)`` (x = log(1 + k) < 11.1: 0..22).
BUCKETS = 24
#: The weight table's key space, apart from the layout's tables.
WEIGHT_TAG = 100

serve, infer_path, model_label, warm_sizes = (hps.serve, hps.infer_path, hps.model_label,
                                              hps.warm_sizes)

CONFIG = {
    "name": "test-dense-buckets", "kind": KIND, "model": "test_dense_buckets",
    "one_key_space": False, "rows_per_table": [300, 40, 1000, 7],
    "keys_per_table_per_sample": [1, 3, 2, 5], "num_dense": 3, "embedding_dim": 16,
    "quant_bits": 8, "embedding_cache_type": "static", "gpucacheper": 1.0,
    "max_batch_size": 512, "deployed_device_list": [0], "default_value": 0.0,
    "num_of_worker_buffer_in_pool": 2, "max_queue_delay_us": 300,
}
MIX = {"loop": "closed", "clients": 3, "pool": 8, "samples_per_request": [3, 10, 17],
       "zipf_exponent": 1.05, "absent_share": 0.05, "keep_bodies": 4, "warm_s": 0.5}
LIMITS = {"wrong_answers": 0, "failed_requests": 0}


def weights(cfg: dict, seed: int) -> np.ndarray:
    """[num_dense x BUCKETS, dim] float32 N(0, 1), from stream (6, 1)."""
    rng = tables.stream(seed, 6, 1)
    return rng.standard_normal((cfg["num_dense"] * BUCKETS, cfg["embedding_dim"]),
                               dtype=np.float32)


def weight_rows(req) -> np.ndarray:
    """The weight row of each sample's features, sample-major."""
    b = np.minimum(np.floor(req.dense * 2).astype(np.int64), BUCKETS - 1)
    return (b + BUCKETS * np.arange(req.dense.shape[1])).reshape(-1)


def weight_keys(rows: np.ndarray) -> np.ndarray:
    return (np.int64(WEIGHT_TAG) << np.int64(tables.KEY_BITS)) | rows


def write(cfg, layout, vectors, work, seed) -> str:
    path = hps.write(cfg, layout, vectors, work, seed)
    w = weights(cfg, seed)
    hps.write_table(os.path.join(work, "weights"), weight_keys(np.arange(len(w))), w)
    with open(path) as f:
        ps = json.load(f)
    m = ps["models"][0]
    m["sparse_files"].append(os.path.join(work, "weights"))
    m["embedding_vecsize_per_table"].append(cfg["embedding_dim"])
    m["maxnum_catfeature_query_per_table_per_sample"].append(cfg["num_dense"])
    m["default_value_for_each_table"].append(cfg["default_value"])
    with open(path, "w") as f:
        json.dump(ps, f)
    return path


def encode(cfg, req):
    keys = list(req.keys) + [weight_keys(weight_rows(req))]
    return binary_request([("KEYS", "INT64", np.concatenate(keys)),
                           ("NUMKEYS", "INT32", np.asarray([k.size for k in keys], np.int32))],
                          "OUTPUT0")


def judge(ctx, control=None) -> dict:
    """Every answer's digest against the reference's (no control: the
    tests run none)."""
    from hpsbench.reference.hps import HpsReference

    if control is not None:
        raise ValueError("the test kind has no control")
    ref = HpsReference(ctx.host_tables() + [weights(ctx.cfg, ctx.seed)], 8,
                       ctx.cfg["default_value"])
    res, want = ctx.results, {}
    wrong = 0
    for i in np.flatnonzero(res.ok):
        e = int(res.entry[i])
        if e not in want:
            req = ctx.requests[e]
            want[e] = ctx.digest(ref.response(list(req.rows) + [weight_rows(req)]))
        wrong += want[e] != res.digest[i].tobytes()
    return {"wrong_answers": (int(wrong), ctx.limits["wrong_answers"])}
