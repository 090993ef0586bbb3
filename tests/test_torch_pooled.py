"""Pooled multi-hot lookups, DIN and BST, and FusedDinServer: the PyTorch
port against the JAX package (BASELINE config 4).

Tolerances:
- lookups (the rows the server hands the model): none (bit-identical).
- pooled sums and means: rtol 1e-6 / atol 1e-6 against the JAX package
  (the same rows, f32 sums in another order); rtol 1e-5 against the f32
  ground truth of an f32 table, 0.02 for an int8 table (quantization), the
  JAX package's own bars.
- logits: rtol 1e-4 / atol 1e-5, the bar of the JAX package's DIN and BST
  tests; both sides compute in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu.serving.pooled as jpooled
import hugectr_backend_tpu_torch as tpkg
import hugectr_backend_tpu_torch.serving.pooled as tpooled
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu.models import BST as FlaxBST
from hugectr_backend_tpu.models import DIN as FlaxDIN
from hugectr_backend_tpu_torch.models import BST, DIN, load_flax_bst_params, load_flax_din_params
from hugectr_backend_tpu_torch.models.din import DinAttentionPool

D, S = 16, 20


def _cfg(root, name, quant_bits):
    return {
        "model": name,
        "sparse_files": [str(root / "target"), str(root / "seq")],
        "embedding_vecsize_per_table": [D, D],
        "maxnum_catfeature_query_per_table_per_sample": [1, S],
        "embedding_table_names": ["target", "behavior"],
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": quant_bits,
        "max_batch_size": 32,
    }


@pytest.fixture(scope="module")
def din_deploy(tmp_path_factory):
    """Model "din": f32 tables (the JAX package's tests); "din8": int8."""
    root = tmp_path_factory.mktemp("torch_din")
    target = make_synthetic_table(800, D, seed=51)
    seq = make_synthetic_table(1200, D, seed=52)
    write_sparse_model(root / "target", target.keys, target.vectors)
    write_sparse_model(root / "seq", seq.keys, seq.vectors)
    cfg = {"models": [_cfg(root, "din", 32), _cfg(root, "din8", 8)]}
    return (jpkg.HierParameterServer.create(cfg),
            tpkg.HierParameterServer.create(cfg, device="cpu"), target, seq)


def _both_pooled(din_deploy, model, keys, seq_len, mode="sum", table=1):
    jps, tps, *_ = din_deploy
    want = np.asarray(jpooled.pooled_lookup(jps.get_embedding_cache(model, 0), table, keys,
                                            seq_len, mode=mode))
    got = tpooled.pooled_lookup(tps.get_embedding_cache(model, 0), table, keys, seq_len,
                                mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    return got


@pytest.mark.parametrize("model", ["din", "din8"])
def test_pooled_sum_masks_padding(din_deploy, model):
    seq_tbl = din_deploy[3]
    b, s = 3, 6
    keys = seq_tbl.keys[np.random.default_rng(0).integers(0, 1200, (b, s))]
    seq_len = np.array([2, 6, 0], np.int32)
    out = _both_pooled(din_deploy, model, keys, seq_len)
    ref = expected_vector(keys.reshape(-1), D).reshape(b, s, D)
    tol = 1e-5 if model == "din" else 0.02
    for i in range(b):
        np.testing.assert_allclose(out[i], ref[i, : seq_len[i]].sum(axis=0), rtol=tol,
                                   atol=tol)


def test_pooled_mean(din_deploy):
    seq_tbl = din_deploy[3]
    keys = seq_tbl.keys[:8].reshape(2, 4)
    out = _both_pooled(din_deploy, "din", keys, np.array([4, 3], np.int32), mode="mean")
    ref = expected_vector(keys.reshape(-1), D).reshape(2, 4, D)
    np.testing.assert_allclose(out[0], ref[0].mean(axis=0), rtol=1e-5)
    np.testing.assert_allclose(out[1], ref[1, :3].mean(axis=0), rtol=1e-5)
    # seq_len None: every key live.
    np.testing.assert_allclose(_both_pooled(din_deploy, "din", keys, None, mode="mean"),
                               ref.mean(axis=1), rtol=1e-5)


def test_pooled_unknown_keys_contribute_default(din_deploy):
    seq_tbl = din_deploy[3]
    keys = np.array([[seq_tbl.keys[0], -999]], np.int64)  # one known, one miss
    out = _both_pooled(din_deploy, "din", keys, np.array([2], np.int32))
    np.testing.assert_allclose(out[0], expected_vector(seq_tbl.keys[:1], D)[0], rtol=1e-5)


def test_pooled_solo_host_scales(tmp_path, monkeypatch):
    """The "solo" kind (host-gathered per-key scales) pools as the JAX
    package does, mean with an empty history included."""
    monkeypatch.setenv("HPS_TPU_ONEHOT_MAX_ROWS", "4")
    monkeypatch.setenv("HPS_TPU_ARENA_MEMBER_MAX_ROWS", "8")
    tbl = make_synthetic_table(300, D, seed=77)
    write_sparse_model(tmp_path / "t", tbl.keys, tbl.vectors)
    cfg = {"models": [{
        "model": "m", "sparse_files": [str(tmp_path / "t")],
        "embedding_vecsize_per_table": [D],
        "maxnum_catfeature_query_per_table_per_sample": [8],
        "gpucacheper": 1.0, "embedding_cache_type": "static", "quant_bits": 8,
    }]}
    jps, tps = jpkg.HierParameterServer.create(cfg), tpkg.HierParameterServer.create(
        cfg, device="cpu")
    assert tps.get_embedding_cache("m", 0).tables[0].arena.scales_host is not None
    b, s = 4, 5
    keys = tbl.keys[np.random.default_rng(3).integers(0, 300, (b, s))]
    seq_len = np.array([5, 2, 0, 4], np.int32)
    out = _both_pooled((jps, tps), "m", keys, seq_len, mode="mean", table=0)
    ref = expected_vector(keys.reshape(-1), D).reshape(b, s, D)
    for i, n in enumerate(seq_len):
        want = ref[i, :n].mean(axis=0) if n else np.zeros(D)
        np.testing.assert_allclose(out[i], want, rtol=0.02, atol=0.02)


@pytest.mark.parametrize("keys, mode, match", [
    (np.zeros((2, 3), np.int64), "max", "unknown pooling mode"),
    (np.zeros(6, np.int64), "sum", r"keys must be \[batch, max_len\]"),
])
def test_pooled_lookup_refuses(din_deploy, keys, mode, match):
    """An unknown mode and keys that are not [B, S] raise, as in the JAX
    package."""
    tps = din_deploy[1]
    with pytest.raises(ValueError, match=match):
        tpooled.pooled_lookup(tps.get_embedding_cache("din", 0), 1, keys, mode=mode)


def _din(seed=0, b=4, nd=8):
    fm = FlaxDIN(mlp_widths=(32, 1), att_hidden=8)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)), jnp.zeros((b, D)),
                     jnp.zeros((b, S, D)), jnp.ones((b,), jnp.int32))
    model = DIN(nd, D, mlp_widths=(32, 1), att_hidden=8)
    model.load_state_dict(load_flax_din_params(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, model


def _bst(seed=0, b=4, nd=3, s=S):
    fm = FlaxBST(num_heads=4, num_layers=2, head_widths=(32, 1))
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)), jnp.zeros((b, D)),
                     jnp.zeros((b, s, D)), jnp.zeros((b,), jnp.int32))
    model = BST(nd, D, s, num_heads=4, num_layers=2, head_widths=(32, 1))
    model.load_state_dict(load_flax_bst_params(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, model


def _inputs(rng, b, nd, s=S):
    return (rng.standard_normal((b, nd)).astype(np.float32),
            rng.standard_normal((b, D)).astype(np.float32),
            rng.standard_normal((b, s, D)).astype(np.float32),
            np.array([0, 1, s // 2, s][:b], np.int32))


@pytest.mark.parametrize("family", ["din", "bst"])
def test_model_forward_matches_flax(family):
    """DIN and BST on the same inputs and carried weights, seq_len 0, 1, S/2
    and S."""
    fm, params, model = _din(1) if family == "din" else _bst(1)
    nd = 8 if family == "din" else 3
    inputs = _inputs(np.random.default_rng(2), 4, nd)
    want = np.asarray(fm.apply(params, *[jnp.asarray(x) for x in inputs]))
    with torch.no_grad():
        got = model(*[torch.from_numpy(x) for x in inputs]).numpy()
    assert got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_din_empty_history_pools_to_zero():
    """seq_len 0: the post-softmax mask makes an empty history pool to zeros
    (a softmax over a fully masked row alone would average the padding)."""
    rng = np.random.default_rng(0)
    b, s, d = 4, 6, 8
    target = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    seq = torch.from_numpy((rng.standard_normal((b, s, d)) * 100).astype(np.float32))
    pool = DinAttentionPool(d, hidden=8)
    pool.mlp.init_flax_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        pooled = pool(target, seq, torch.tensor([0, 3, 0, 6])).numpy()
    np.testing.assert_array_equal(pooled[0], 0.0)
    np.testing.assert_array_equal(pooled[2], 0.0)
    assert np.abs(pooled[1]).max() > 0 and np.abs(pooled[3]).max() > 0


def test_bst_padding_invariance():
    """BST's logits do not depend on the padded positions."""
    _, _, model = _bst(0, b=4, nd=3, s=6)
    rng = np.random.default_rng(0)
    dense, target, seq, _ = _inputs(rng, 4, 3, s=6)
    seq_len = np.array([0, 2, 4, 6], np.int32)
    seq2 = seq.copy()
    for i, n in enumerate(seq_len):
        seq2[i, n:] = 777.0
    with torch.no_grad():
        y1, y2 = (model(torch.from_numpy(dense), torch.from_numpy(target), torch.from_numpy(x),
                        torch.from_numpy(seq_len)).numpy() for x in (seq, seq2))
    np.testing.assert_allclose(y1, y2, rtol=1e-5, atol=1e-6)
    assert np.isfinite(y1).all()


def test_bst_position_and_history_sensitivity():
    """Order matters (positional embeddings), and so does the history."""
    _, _, model = _bst(1, b=2, nd=2, s=5)
    rng = np.random.default_rng(1)
    dense, target, seq, _ = (torch.from_numpy(x) for x in _inputs(rng, 2, 2, s=5))
    seq_len = torch.full((2,), 5)
    with torch.no_grad():
        y = model(dense, target, seq, seq_len)
        y_rev = model(dense, target, seq.flip(1), seq_len)
        y_other = model(dense, target, seq + 0.5, seq_len)
    assert (y - y_rev).abs().max() > 1e-5
    assert (y - y_other).abs().max() > 1e-5


def test_bst_refuses_shapes():
    with pytest.raises(ValueError, match="must divide num_heads"):
        BST(2, 10, 4, num_heads=4)
    model = BST(2, 8, 4, num_heads=2).init_flax_(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="learned for 4"):
        model(torch.zeros(1, 2), torch.zeros(1, 8), torch.zeros(1, 5, 8), torch.ones(1))


def _din_traffic(din_deploy, rng, b, nd):
    target_tbl, seq_tbl = din_deploy[2:]
    tkeys = target_tbl.keys[rng.integers(0, 800, b)]
    skeys = seq_tbl.keys[rng.integers(0, 1200, (b, S))]
    seq_len = rng.integers(0, S + 1, b).astype(np.int32)
    seq_len[0] = 0
    return tkeys, skeys, seq_len, rng.standard_normal((b, nd)).astype(np.float32)


@pytest.mark.parametrize("family", ["din", "bst"])
def test_fused_din_server_matches_jax(din_deploy, family):
    """FusedDinServer with DIN and with BST on the int8 deployment: logits
    against the JAX package's server, and the padded tail does not count."""
    jps, tps, *_ = din_deploy
    fm, params, model = _din(3) if family == "din" else _bst(3)
    nd = 8 if family == "din" else 3
    jsrv = jpooled.FusedDinServer(jps.get_model_params("din8"),
                                  jps.get_embedding_cache("din8", 0), fm, params)
    tsrv = tpooled.FusedDinServer(tps.get_model_params("din8"),
                                  tps.get_embedding_cache("din8", 0), model)
    assert tsrv.max_seq == S
    tkeys, skeys, seq_len, dense = _din_traffic(din_deploy, np.random.default_rng(4), 4, nd)
    want = np.asarray(jsrv.predict(tkeys, skeys, seq_len, dense))
    got = tsrv.predict(tkeys, skeys, seq_len, dense).numpy()
    assert got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    skeys2 = skeys.copy()
    for i, n in enumerate(seq_len):
        skeys2[i, n:] = -12345  # misses in the padding
    np.testing.assert_allclose(tsrv.predict(tkeys, skeys2, seq_len, dense).numpy(), got,
                               rtol=1e-4, atol=1e-5)


class _Rows(torch.nn.Module):
    """A stand-in model that returns the rows the server gathered."""

    def forward(self, dense, target, seq, seq_len):
        return target, seq


class _FlaxRows:
    def apply(self, params, dense, target, seq, seq_len):
        return target, seq


@pytest.mark.parametrize("model", ["din", "din8"])
def test_fused_din_server_lookups_bit_identical(din_deploy, model):
    """The target rows [B, D] and sequence rows [B, S, D] FusedDinServer
    hands the model, bit-identical to the JAX package's."""
    jps, tps, *_ = din_deploy
    jsrv = jpooled.FusedDinServer(jps.get_model_params(model), jps.get_embedding_cache(model, 0),
                                  _FlaxRows(), {})
    tsrv = tpooled.FusedDinServer(tps.get_model_params(model), tps.get_embedding_cache(model, 0),
                                  _Rows())
    tkeys, skeys, seq_len, dense = _din_traffic(din_deploy, np.random.default_rng(5), 6, 2)
    skeys[1, 3] = -7  # a miss
    for got, want in zip(tsrv.predict(tkeys, skeys, seq_len, dense),
                         jsrv.predict(tkeys, skeys, seq_len, dense)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
