"""Two-tower retrieval: ``TwoTowerUser`` and ``RetrievalServer`` of the
PyTorch port against the JAX package, on the same ps.json, weights and keys.

Tolerances:
- retrieved keys: none (identical, ties included: ``lax.top_k`` puts the
  lower corpus index first among equal scores, and so does the port).
- scores: rtol 1e-5 / atol 1e-6 against the JAX server (the same f32 or
  bf16-operand products, f32 sums in another order); the JAX package's
  own bars against the brute-force numpy reference (rtol 1e-4 / atol 1e-5
  for f32, atol 0.05 and recall >= 0.8 for int8).
- the user tower: rtol 1e-5 / atol 1e-6.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu_torch as tpkg
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu.models.two_tower import TwoTowerUser as FlaxTower
from hugectr_backend_tpu.serving.retrieval import RetrievalServer as JaxRetrieval
from hugectr_backend_tpu_torch.models import TwoTowerUser, load_flax_two_tower_params
from hugectr_backend_tpu_torch.serving.retrieval import RetrievalServer, top_k


def _deploy(root, name, n_users, n_items, dim, quant_bits, items=None, **extra):
    users = make_synthetic_table(n_users, dim, seed=31)
    items = items or make_synthetic_table(n_items, dim, seed=32)
    write_sparse_model(root / f"{name}_u", users.keys, users.vectors)
    write_sparse_model(root / f"{name}_i", items.keys, items.vectors)
    cfg = {"models": [{
        "model": name,
        "sparse_files": [str(root / f"{name}_u"), str(root / f"{name}_i")],
        "embedding_vecsize_per_table": [dim, dim],
        "maxnum_catfeature_query_per_table_per_sample": [1, 1],
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": quant_bits,
        **extra,
    }]}
    return (jpkg.HierParameterServer.create(cfg),
            tpkg.HierParameterServer.create(cfg, device="cpu"), users, items)


def _tower(dim, nd, b, seed=0, normalize=True):
    fm = FlaxTower(widths=(32, dim), normalize=normalize)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)), jnp.zeros((b, 1, dim)))
    model = TwoTowerUser(nd, 1, dim, widths=(32, dim), normalize=normalize)
    model.load_state_dict(load_flax_two_tower_params(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, model


def _servers(jps, tps, name, fm, params, model, k):
    return (JaxRetrieval(jps.get_model_params(name), jps.get_embedding_cache(name, 0), fm,
                         params, k=k),
            RetrievalServer(tps.get_model_params(name), tps.get_embedding_cache(name, 0),
                            model, k=k))


@pytest.mark.parametrize("normalize", [True, False])
def test_two_tower_user_matches_flax(normalize):
    fm, params, model = _tower(16, 4, 6, seed=1, normalize=normalize)
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((6, 4)).astype(np.float32)
    emb = rng.standard_normal((6, 1, 16)).astype(np.float32)
    want = np.asarray(fm.apply(params, jnp.asarray(dense), jnp.asarray(emb)))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_retrieval_exact_fp32(tmp_path):
    """fp32 corpus: keys identical to the JAX server's and to the numpy
    brute force, scores descending."""
    dim, nd, b, k = 16, 4, 6, 8
    jps, tps, users, items = _deploy(tmp_path, "tt", 800, 600, dim, 32)
    fm, params, model = _tower(dim, nd, b)
    jsrv, tsrv = _servers(jps, tps, "tt", fm, params, model, k)
    rng = np.random.default_rng(0)
    ukeys = users.keys[rng.integers(0, 800, b)]
    dense = rng.standard_normal((b, nd)).astype(np.float32)
    got_keys, got_scores = tsrv.retrieve(ukeys, dense)
    want_keys, want_scores = jsrv.retrieve(ukeys, dense)
    assert got_keys.shape == (b, k) and got_keys.dtype == np.int64
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-6)
    uemb = expected_vector(ukeys, dim).reshape(b, 1, dim)
    q = np.asarray(fm.apply(params, jnp.asarray(dense), jnp.asarray(uemb)))
    corpus_keys = np.sort(items.keys)
    scores = q @ expected_vector(corpus_keys, dim).T
    order = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(got_keys, corpus_keys[order])
    np.testing.assert_allclose(got_scores, np.take_along_axis(scores, order, axis=1),
                               rtol=1e-4, atol=1e-5)
    assert (np.diff(got_scores, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("quant_bits", [8, 16])
def test_retrieval_quantized_corpus(tmp_path, quant_bits):
    """int8 and bf16 corpora (bf16 operands, f32 sums, the scales after the
    product): keys identical to the JAX server's; for int8, recall >= 0.8
    against the f32 brute force and scores within 0.05 of the exact ones."""
    dim, nd, b, k = 16, 0, 4, 20
    jps, tps, users, items = _deploy(tmp_path, "tq", 500, 400, dim, quant_bits)
    fm, params, model = _tower(dim, nd, b, seed=1)
    jsrv, tsrv = _servers(jps, tps, "tq", fm, params, model, k)
    ukeys = users.keys[np.random.default_rng(1).integers(0, 500, b)]
    dense = np.zeros((b, nd), np.float32)
    got_keys, got_scores = tsrv.retrieve(ukeys, dense)
    want_keys, want_scores = jsrv.retrieve(ukeys, dense)
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-6)
    q = np.asarray(fm.apply(params, jnp.asarray(dense),
                            jnp.asarray(expected_vector(ukeys, dim).reshape(b, 1, dim))))
    corpus_keys = np.sort(items.keys)
    scores = q @ expected_vector(corpus_keys, dim).T
    want_top = corpus_keys[np.argsort(-scores, axis=1)[:, :k]]
    assert min(len(set(got_keys[i]) & set(want_top[i])) / k for i in range(b)) >= 0.8
    pos = {int(kk): j for j, kk in enumerate(corpus_keys)}
    for i in range(b):
        exact = scores[i, [pos[int(kk)] for kk in got_keys[i]]]
        np.testing.assert_allclose(got_scores[i], exact, rtol=0, atol=0.05)


def test_retrieval_tie_order_on_duplicated_rows(tmp_path):
    """An int8 corpus whose rows repeat (each vector under three keys) gives
    equal scores: the port orders them as lax.top_k does, the lower corpus
    index (the smaller key) first."""
    dim, nd, b, k = 16, 2, 5, 30
    base = make_synthetic_table(40, dim, seed=33)
    items = SimpleNamespace(keys=np.arange(1, 121, dtype=np.int64),
                            vectors=np.concatenate([base.vectors] * 3))
    jps, tps, users, _ = _deploy(tmp_path, "tie", 300, 120, dim, 8, items=items)
    fm, params, model = _tower(dim, nd, b, seed=2)
    jsrv, tsrv = _servers(jps, tps, "tie", fm, params, model, k)
    rng = np.random.default_rng(2)
    ukeys = users.keys[rng.integers(0, 300, b)]
    dense = rng.standard_normal((b, nd)).astype(np.float32)
    got_keys, got_scores = tsrv.retrieve(ukeys, dense)
    want_keys, want_scores = jsrv.retrieve(ukeys, dense)
    assert (np.diff(got_scores, axis=1) == 0).sum() >= b * (k // 3 - 1)  # ties are there
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_scores, want_scores)
    for i in range(b):
        for j in range(k - 1):
            if got_scores[i, j] == got_scores[i, j + 1]:
                assert got_keys[i, j] < got_keys[i, j + 1]
    # A smaller k is a prefix; k is checked per call.
    np.testing.assert_array_equal(tsrv.retrieve(ukeys, dense, k=7)[0], got_keys[:, :7])
    with pytest.raises(ValueError, match="corpus size 120"):
        tsrv.retrieve(ukeys, dense, k=121)


def test_top_k_matches_lax_top_k():
    """top_k against lax.top_k on rows with ties, negative scores and signed
    zeros (-0.0 ranks below +0.0 in both): the same indices, the same
    values; on the rows without -0.0, numpy's stable argsort agrees."""
    rng = np.random.default_rng(3)
    s = rng.integers(-4, 5, (7, 50)).astype(np.float32) / 4
    s[0, :10] = -0.0
    s[1, ::3] = np.float32(-1e30)
    s[2] = rng.standard_normal(50).astype(np.float32)
    for k in (1, 13, 50):
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_v, got_i = top_k(torch.from_numpy(s), k, rows=3)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy()[1:],
                                      np.argsort(-s[1:], axis=1, kind="stable")[:, :k])


@pytest.mark.parametrize("case, match", [
    ("int4", "int4"),
    ("dynamic", "static"),
    ("k0", r"k=0 must be in \[1, corpus size 300\]"),
    ("k_big", r"k=301 must be in \[1, corpus size 300\]"),
])
def test_retrieval_refusals(tmp_path, case, match):
    """The JAX package's refusals: an int4 corpus, a cache other than
    static, k outside [1, corpus size]."""
    dim = 16
    extra = {"embedding_cache_type": "dynamic"} if case == "dynamic" else {}
    jps, tps, *_ = _deploy(tmp_path, "r", 300, 300, dim, 4 if case == "int4" else 8, **extra)
    _, _, model = _tower(dim, 0, 2)
    k = {"k0": 0, "k_big": 301}.get(case, 10)
    try:
        with pytest.raises(ValueError, match=match):
            RetrievalServer(tps.get_model_params("r"), tps.get_embedding_cache("r", 0), model,
                            k=k)
    finally:
        tps.shutdown()
