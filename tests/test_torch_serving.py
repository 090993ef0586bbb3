"""The slice as a whole: the same ps.json and sparse files served by the JAX
package and by the PyTorch port (parameter server -> static cache -> lookup
session -> fused DLRM server), on int8 and fp8 tables that mix the one-hot,
arena and solo lookup kinds.

Tolerances:
- lookups: none (bit-identical). Both packages quantize the same rows the same
  way and dequantize with one f32 multiply; misses return the default row.
- logits: rtol 1e-4 / atol 1e-5, the bar of the JAX package's fused-model
  tests. The JAX server runs with ``HPS_PALLAS_INTERPRET=1``, so its
  interaction is the Pallas body (K3 with the one-hot fold, K2 with
  ``HPS_OH_IN_KERNEL=0``); the two sides differ only in f32 summation order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu_torch as tpkg
import hugectr_backend_tpu_torch.models.dlrm as tdlrm
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import make_synthetic_table
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.serving.program import make_dlrm_multi_server as jax_server
from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params
from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server as torch_server

DIM = 128  # the JAX package's in-kernel fold needs a lane-aligned dim
# With the thresholds below: tables 0-1 one-hot, 2-3 arena, 4-5 solo.
SIZES = [30, 50, 100, 200, 400, 600]
THRESHOLDS = {"HPS_TPU_ONEHOT_MAX_ROWS": "64", "HPS_TPU_ARENA_MEMBER_MAX_ROWS": "256"}
B, ND = 8, 4


def _config(root, quant, gpucacheper=1.0):
    model = {
        "model": "dlrm",
        "sparse_files": [str(root / f"t{t}") for t in range(len(SIZES))],
        "embedding_vecsize_per_table": [DIM] * len(SIZES),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(SIZES),
        "default_value_for_each_table": [0.0, 0.5, 0.0, -0.25, 0.0, 1.0],
        "gpucacheper": gpucacheper,
        "embedding_cache_type": "static",
    }
    model.update({"fp8_quant": True} if quant == "fp8" else {"quant_bits": 8})
    return {"models": [model]}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    tbls = [make_synthetic_table(n, DIM, seed=90 + t) for t, n in enumerate(SIZES)]
    for t, tbl in enumerate(tbls):
        write_sparse_model(root / f"t{t}", tbl.keys, tbl.vectors)
    return root, tbls


def _deploy(tables, quant, gpucacheper=1.0):
    root, _ = tables
    cfg = _config(root, quant, gpucacheper)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in THRESHOLDS.items():
            mp.setenv(k, v)
        jps = jpkg.HierParameterServer.create(cfg)
        tps = tpkg.HierParameterServer.create(cfg, device="cpu")
    return jps, tps


def _keys(tbls, rng, n):
    """n keys per table, ~1 in 8 absent from the table."""
    out = []
    for tbl in tbls:
        k = tbl.keys[rng.integers(0, tbl.num_rows, n)].copy()
        k[rng.random(n) < 0.125] = -7 - rng.integers(0, 1000)
        out.append(k)
    return out


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_lookup_bit_identical(tables, quant):
    jps, tps = _deploy(tables, quant)
    jcache, tcache = jps.get_embedding_cache("dlrm", 0), tps.get_embedding_cache("dlrm", 0)
    kinds = [g[1] for g in tcache._groups]
    assert kinds == [g[1] for g in jcache._groups]
    assert {"onehot", "arena", "solo"} <= set(kinds)
    jsess = jpkg.LookupSession.create(jps.get_model_params("dlrm"), jcache)
    tsess = tpkg.LookupSession.create(tps.get_model_params("dlrm"), tcache)
    keys = _keys(tables[1], np.random.default_rng(1), 37)
    for got, want in zip(tsess.lookup(keys), jsess.lookup(keys)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    flat = np.concatenate(keys)
    num = np.array([k.size for k in keys])
    np.testing.assert_array_equal(tsess.lookup_from_request(flat, num),
                                  jsess.lookup_from_request(flat, num))
    np.testing.assert_array_equal(tsess.lookup_flat(keys, pad_counts=[40] * 6).numpy(),
                                  np.asarray(jsess.lookup_flat(keys, pad_counts=[40] * 6)))


def test_lookup_tier_merge_bit_identical(tables):
    """gpucacheper 0.5: half of each table is not on the device; its rows
    come from the DRAM tier through the miss-merge, exact f32."""
    jps, tps = _deploy(tables, "int8", gpucacheper=0.5)
    jcache, tcache = jps.get_embedding_cache("dlrm", 0), tps.get_embedding_cache("dlrm", 0)
    keys = _keys(tables[1], np.random.default_rng(2), 50)
    got = tcache.lookup(keys)
    for g, w in zip(got, jcache.lookup(keys)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    merged = 0
    for t, tbl in enumerate(tables[1]):
        assert tcache.tables[t].capacity < tbl.num_rows
        pos = {int(k): i for i, k in enumerate(tbl.keys)}
        for i, k in enumerate(keys[t]):
            off_device = tcache.tables[t].index.lookup([k])[0] == tcache.tables[t].index.miss_slot
            if off_device and int(k) in pos:
                np.testing.assert_array_equal(got[t][i].numpy(), tbl.vectors[pos[int(k)]])
                merged += 1
    assert merged > 0
    np.testing.assert_array_equal(
        tcache.lookup_flat(keys).numpy(), np.concatenate([g.numpy().ravel() for g in got]))


@pytest.mark.parametrize("fold", [True, False], ids=["fold_k3", "no_fold_k2"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_dlrm_server_logits_match_jax(tables, monkeypatch, quant, fold):
    jps, tps = _deploy(tables, quant)
    flax_model = FlaxDLRM(bottom_widths=(16, DIM), top_widths=(16, 1))
    params = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((B, ND)),
                             jnp.zeros((B, len(SIZES), DIM)))
    model = DLRM(ND, len(SIZES), bottom_widths=(16, DIM), top_widths=(16, 1))
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    keys = [k.reshape(B, 1) for k in _keys(tables[1], rng, B)]
    dense = rng.standard_normal((B, ND)).astype(np.float32)

    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    if not fold:
        monkeypatch.setenv("HPS_OH_IN_KERNEL", "0")
    jsrv = jax_server(jps.get_model_params("dlrm"), jps.get_embedding_cache("dlrm", 0),
                      flax_model, params)
    tsrv = torch_server(tps.get_model_params("dlrm"), tps.get_embedding_cache("dlrm", 0),
                        model)
    want = np.asarray(jsrv.predict(keys, dense))
    calls = {"dot_interaction_parts": 0, "dot_interaction_oh_parts": 0}
    for name in calls:
        def spy(*a, _n=name, _f=getattr(tdlrm, name)):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(tdlrm, name, spy)
    got = tsrv.predict(keys, dense).numpy()
    assert calls == ({"dot_interaction_parts": 0, "dot_interaction_oh_parts": 1} if fold
                     else {"dot_interaction_parts": 1, "dot_interaction_oh_parts": 0})
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
