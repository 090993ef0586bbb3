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
- logits of a quantized-dense DLRM (``quant_fmt`` w8a8, int8, fp8) and of
  ``use_mixed_precision``: |delta| <= 1e-2 * max|logit|. The interaction
  inputs to the top MLP sit up to an f32 ulp apart (summation order), and a
  quantizing (w8a8) or bf16-rounding step can move such an element by one
  step (tests/test_torch_quant_dense.py states the same bar).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu_torch as tpkg
import hugectr_backend_tpu_torch.models.dlrm as tdlrm
import hugectr_backend_tpu_torch.models.quant_dense as tqd
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import make_synthetic_table
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.models.quant_dense import quantize_model_params
from hugectr_backend_tpu.serving.program import make_dlrm_multi_server as jax_server
from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params
from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server as torch_server

DIM = 128  # the JAX package's in-kernel fold needs a lane-aligned dim
# With the thresholds below: tables 0-1 one-hot, 2-3 arena, 4-5 solo.
SIZES = [30, 50, 100, 200, 400, 600]
THRESHOLDS = {"HPS_TPU_ONEHOT_MAX_ROWS": "64", "HPS_TPU_ARENA_MEMBER_MAX_ROWS": "256"}
B, ND = 8, 4


def _config(root, quant, gpucacheper=1.0, **extra):
    model = {
        "model": "dlrm",
        "sparse_files": [str(root / f"t{t}") for t in range(len(SIZES))],
        "embedding_vecsize_per_table": [DIM] * len(SIZES),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(SIZES),
        "default_value_for_each_table": [0.0, 0.5, 0.0, -0.25, 0.0, 1.0],
        "gpucacheper": gpucacheper,
        "embedding_cache_type": "static",
        **extra,
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


def _deploy(tables, quant, gpucacheper=1.0, **extra):
    root, _ = tables
    cfg = _config(root, quant, gpucacheper, **extra)
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


def _close(got, want):
    assert got.shape == want.shape == (B,)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("fold", [True, False], ids=["fold_k3", "no_fold_k2"])
@pytest.mark.parametrize("dense_fmt", ["w8a8", "int8", "fp8"])
def test_quant_dense_server_logits_match_jax(tables, monkeypatch, dense_fmt, fold):
    """int8 tables, quantized dense layers: the serving variants
    ``int8+dense_*`` of the JAX package's eval/auc_parity.py. w8a8 weights
    are quantized as int8 (the same bytes), as there."""
    jps, tps = _deploy(tables, "int8")
    f32 = FlaxDLRM(bottom_widths=(16, DIM), top_widths=(16, 1))
    params = f32.init(jax.random.PRNGKey(1), jnp.zeros((B, ND)), jnp.zeros((B, len(SIZES), DIM)))
    qparams = quantize_model_params(params, fmt="int8" if dense_fmt == "w8a8" else dense_fmt)
    flax_model = FlaxDLRM(bottom_widths=(16, DIM), top_widths=(16, 1), quant_fmt=dense_fmt)
    model = DLRM(ND, len(SIZES), bottom_widths=(16, DIM), top_widths=(16, 1),
                 quant_fmt=dense_fmt)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, qparams)))
    rng = np.random.default_rng(4)
    keys = [k.reshape(B, 1) for k in _keys(tables[1], rng, B)]
    dense = rng.standard_normal((B, ND)).astype(np.float32)

    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    if not fold:
        monkeypatch.setenv("HPS_OH_IN_KERNEL", "0")
    jsrv = jax_server(jps.get_model_params("dlrm"), jps.get_embedding_cache("dlrm", 0),
                      flax_model, qparams)
    tsrv = torch_server(tps.get_model_params("dlrm"), tps.get_embedding_cache("dlrm", 0),
                        model)
    want = np.asarray(jsrv.predict(keys, dense))
    calls = []
    real = tqd.w8a8_dense
    monkeypatch.setattr(tqd, "w8a8_dense", lambda *a: calls.append(a[1].shape) or real(*a))
    got = tsrv.predict(keys, dense).numpy()
    assert len(calls) == (4 if dense_fmt == "w8a8" else 0)
    _close(got, want)


def test_mixed_precision_server_matches_bf16_reference(tables, monkeypatch):
    """``use_mixed_precision``: bf16 operands, f32 sums in the dense products.
    The JAX server's switch (``jax.default_matmul_precision``) does nothing
    on a CPU, so the reference is the Flax DLRM's arithmetic with explicit
    bf16 casts (tests/test_torch_quant_dense.py) on the JAX package's
    lookups."""
    from test_torch_quant_dense import jax_bf16_dlrm

    jps, tps = _deploy(tables, "int8", use_mixed_precision=True)
    assert tps.get_model_params("dlrm").use_mixed_precision
    flax_model = FlaxDLRM(bottom_widths=(16, DIM), top_widths=(16, 1))
    params = flax_model.init(jax.random.PRNGKey(2), jnp.zeros((B, ND)),
                             jnp.zeros((B, len(SIZES), DIM)))
    model = DLRM(ND, len(SIZES), bottom_widths=(16, DIM), top_widths=(16, 1))
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(5)
    keys = [k.reshape(B, 1) for k in _keys(tables[1], rng, B)]
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    jsess = jpkg.LookupSession.create(jps.get_model_params("dlrm"),
                                      jps.get_embedding_cache("dlrm", 0))
    emb = jnp.stack([jnp.asarray(v) for v in jsess.lookup([k.reshape(-1) for k in keys])], axis=1)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    want = np.asarray(jax_bf16_dlrm(params, jnp.asarray(dense), emb))
    tsrv = torch_server(tps.get_model_params("dlrm"), tps.get_embedding_cache("dlrm", 0),
                        model)
    got = tsrv.predict(keys, dense).numpy()
    _close(got, want)
    want_f32 = np.asarray(jax_server(jps.get_model_params("dlrm"),
                                     jps.get_embedding_cache("dlrm", 0),
                                     flax_model, params).predict(keys, dense))
    assert not np.array_equal(got, want_f32)
