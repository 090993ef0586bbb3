"""The model zoo's multi-table families (WDL, DCN-v2, DeepFM, xDeepFM, NCF,
MMoE) and their servers: the PyTorch port against the JAX package.

Each Flax model is initialised in the JAX package and carried across with
its ``load_flax_<model>_params``. One ps.json of int8 tables that mix the
one-hot, arena and solo lookup kinds is served by both packages.

Tolerances:
- lookups: none (bit-identical). Both packages quantize the same rows the
  same way and dequantize with one f32 multiply.
- logits: rtol 1e-4 / atol 1e-5, the bar of the JAX package's fused-model
  tests. Both sides compute in f32 and differ only in summation order.
- ``use_mixed_precision``: |delta| <= 1e-2 * max|logit| against the JAX
  server. XLA on the CPU computes f32 products whatever the matmul
  precision, the port rounds each product's operands to bf16 (its rule,
  held separately: every product of the forward sees bf16-exact operands).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu.serving.program as jprog
import hugectr_backend_tpu_torch as tpkg
import hugectr_backend_tpu_torch.models as tmodels
import hugectr_backend_tpu_torch.serving.program as tprog
from hugectr_backend_tpu import models as jmodels
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import make_synthetic_table
from hugectr_backend_tpu.models.xdeepfm import CINLayer as FlaxCIN
from hugectr_backend_tpu_torch.models.xdeepfm import CINLayer, load_flax_xdeepfm_params

# With these thresholds a table of 30 rows is one-hot, 200 arena, 600 solo.
THRESHOLDS = {"HPS_TPU_ONEHOT_MAX_ROWS": "64", "HPS_TPU_ARENA_MEMBER_MAX_ROWS": "256"}
TABLES = {  # name: (rows, dim)
    "w30": (30, 1), "w200": (200, 1),
    "a30": (30, 16), "a200": (200, 16), "a600": (600, 16),
    "s30": (30, 8), "s200": (200, 8), "s600": (600, 8),
}
B, ND = 8, 4

# family: (tables, keys per sample, dense width, Flax model, port model,
# JAX server, port server, loader)
FAMILIES = {
    "wdl": (["w30", "a600"], [2, 5], ND,
            lambda: jmodels.WideAndDeep(deep_widths=(32, 1)),
            lambda: tmodels.WideAndDeep(ND, 5, 16, deep_widths=(32, 1)),
            jprog.make_wdl_server, tprog.make_wdl_server, tmodels.load_flax_wdl_params),
    "deepfm": (["w200", "a30"], [4, 4], ND,
               lambda: jmodels.DeepFM(deep_widths=(16, 1)),
               lambda: tmodels.DeepFM(ND, 4, 16, deep_widths=(16, 1)),
               jprog.make_deepfm_server, tprog.make_deepfm_server,
               tmodels.load_flax_deepfm_params),
    "ncf": (["a600", "a200"], [1, 1], 0,
            lambda: jmodels.NCF(mlp_widths=(16, 8)),
            lambda: tmodels.NCF(0, 16, mlp_widths=(16, 8)),
            jprog.make_ncf_server, tprog.make_ncf_server, tmodels.load_flax_ncf_params),
    "dcn": (["s30", "s200", "s600"], [1, 1, 2], ND,
            lambda: jmodels.DCNv2(num_cross_layers=2, cross_rank=4, deep_widths=(16,),
                                  head_widths=(8, 1)),
            lambda: tmodels.DCNv2(ND, 4, 8, num_cross_layers=2, cross_rank=4,
                                  deep_widths=(16,), head_widths=(8, 1)),
            jprog.make_dcn_server, tprog.make_dcn_server, tmodels.load_flax_dcn_params),
    "xdeepfm": (["s600", "s30"], [2, 3], ND,
                lambda: jmodels.XDeepFM(cin_feature_maps=(4, 3), deep_widths=(16, 1)),
                lambda: tmodels.XDeepFM(ND, 5, 8, cin_feature_maps=(4, 3),
                                        deep_widths=(16, 1)),
                jprog.make_xdeepfm_server, tprog.make_xdeepfm_server,
                tmodels.load_flax_xdeepfm_params),
    "mmoe": (["s200", "s30", "s600"], [1, 1, 2], ND,
             lambda: jmodels.MMoE(num_experts=3, num_tasks=2, expert_widths=(16, 8),
                                  tower_widths=(8, 1)),
             lambda: tmodels.MMoE(ND, 4, 8, num_experts=3, num_tasks=2,
                                  expert_widths=(16, 8), tower_widths=(8, 1)),
             jprog.make_mmoe_server, tprog.make_mmoe_server, tmodels.load_flax_mmoe_params),
}
STACKED = ("dcn", "xdeepfm", "mmoe")


def _model_cfg(root, family, **extra):
    names, kps = FAMILIES[family][:2]
    return {
        "model": family,
        "sparse_files": [str(root / n) for n in names],
        "embedding_vecsize_per_table": [TABLES[n][1] for n in names],
        "maxnum_catfeature_query_per_table_per_sample": kps,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        **extra,
    }


def _create(cfg):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in THRESHOLDS.items():
            mp.setenv(k, v)
        return jpkg.HierParameterServer.create(cfg), tpkg.HierParameterServer.create(
            cfg, device="cpu")


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_zoo")
    tbls = {}
    for i, (name, (rows, dim)) in enumerate(TABLES.items()):
        tbls[name] = make_synthetic_table(rows, dim, seed=40 + i)
        write_sparse_model(root / name, tbls[name].keys, tbls[name].vectors)
    jps, tps = _create({"models": [_model_cfg(root, f) for f in FAMILIES]})
    return root, tbls, jps, tps


def _keys(zoo, family, rng, b=B):
    """Keys per table [B, K_t], ~1 in 8 absent from the table."""
    _, tbls, *_ = zoo
    names, kps = FAMILIES[family][:2]
    out = []
    for n, k in zip(names, kps):
        keys = tbls[n].keys[rng.integers(0, tbls[n].num_rows, (b, k))].copy()
        keys[rng.random((b, k)) < 0.125] = -5 - rng.integers(0, 1000)
        out.append(keys)
    return out


def _flax_inputs(family, b=B):
    """Zero inputs of the Flax model's init for ``family``."""
    names, kps, nd = FAMILIES[family][:3]
    dims = [TABLES[n][1] for n in names]
    blocks = [jnp.zeros((b, k, d)) for k, d in zip(kps, dims)]
    if family in STACKED:
        blocks = [jnp.concatenate(blocks, axis=1)]
    return [jnp.zeros((b, nd))] + blocks


def _carried(family, seed=0):
    """(Flax model, its params, the port's model with them carried across)."""
    *_, jmodel, tmodel, _js, _ts, load = FAMILIES[family]
    fm = jmodel()
    params = fm.init(jax.random.PRNGKey(seed), *_flax_inputs(family))
    model = tmodel()
    model.load_state_dict(load(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, model


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_forward_matches_flax(family):
    """The port's forward on embeddings drawn from a seed against the Flax
    model's, same weights."""
    fm, params, model = _carried(family, seed=1)
    rng = np.random.default_rng(2)
    inputs = [rng.standard_normal(x.shape).astype(np.float32) for x in _flax_inputs(family)]
    want = np.asarray(fm.apply(params, *[jnp.asarray(x) for x in inputs]))
    with torch.no_grad():
        got = model(*[torch.from_numpy(x) for x in inputs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_server_matches_jax(zoo, family):
    """make_<family>_server: the same ps.json, weights and keys in both
    packages, logits within rtol 1e-4 / atol 1e-5."""
    _, _, jps, tps = zoo
    nd = FAMILIES[family][2]
    jserver, tserver = FAMILIES[family][5:7]
    fm, params, model = _carried(family)
    jsrv = jserver(jps.get_model_params(family), jps.get_embedding_cache(family, 0), fm, params)
    tsrv = tserver(tps.get_model_params(family), tps.get_embedding_cache(family, 0), model)
    assert not tsrv.chunked
    rng = np.random.default_rng(3)
    for _ in range(2):
        keys = _keys(zoo, family, rng)
        dense = rng.standard_normal((B, nd)).astype(np.float32)
        want = np.asarray(jsrv.predict(keys, dense))
        got = tsrv.predict(keys, dense).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_server_lookups_bit_identical(zoo, family):
    """The blocks the non-chunked FusedMultiTableServer hands the model:
    a list of per-table [B, K_t, D_t], bit-identical to the JAX package's."""
    _, _, jps, tps = zoo
    nd = FAMILIES[family][2]
    jsrv = jprog.FusedMultiTableServer(jps.get_model_params(family),
                                       jps.get_embedding_cache(family, 0),
                                       lambda dense, embs: embs)
    tsrv = tprog.FusedMultiTableServer(tps.get_model_params(family),
                                       tps.get_embedding_cache(family, 0),
                                       lambda dense, embs: embs)
    rng = np.random.default_rng(4)
    keys = _keys(zoo, family, rng)
    dense = np.zeros((B, nd), np.float32)
    want, got = jsrv.predict(keys, dense), tsrv.predict(keys, dense)
    assert isinstance(got, list) and len(got) == len(want) == len(keys)
    for g, w, k in zip(got, want, keys):
        assert tuple(g.shape) == k.shape + (w.shape[-1],)
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


class _Products:
    """Records, for each F.linear / torch.matmul / torch.einsum call, whether
    every tensor operand is exact in bf16."""

    def __init__(self, monkeypatch):
        self.exact = []
        for mod, name in ((F, "linear"), (torch, "matmul"), (torch, "einsum")):
            orig = getattr(mod, name)

            def rec(*args, _o=orig, _n=name, **kw):
                ts = [a for a in args if isinstance(a, torch.Tensor)]
                if _n == "linear":
                    ts = ts[:2]  # the bias is added in f32
                self.exact.append(all(bool((t == t.to(torch.bfloat16).float()).all())
                                      for t in ts))
                return _o(*args, **kw)

            monkeypatch.setattr(mod, name, rec)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mixed_precision_reaches_every_product(zoo, family, monkeypatch):
    """use_mixed_precision: every product of the served forward (the
    nn.Linear layers and the einsums of CIN, MMoE and the cross layers)
    takes bf16-exact operands; without it, not."""
    root, _, _, _ = zoo
    with pytest.MonkeyPatch.context() as mp:
        for k, v in THRESHOLDS.items():
            mp.setenv(k, v)
        tps = tpkg.HierParameterServer.create(
            {"models": [_model_cfg(root, family, use_mixed_precision=True)]}, device="cpu")
    _, _, model = _carried(family)
    tserver = FAMILIES[family][6]
    srv = tserver(tps.get_model_params(family), tps.get_embedding_cache(family, 0), model)
    rng = np.random.default_rng(5)
    keys = _keys(zoo, family, rng)
    dense = rng.standard_normal((B, FAMILIES[family][2])).astype(np.float32)
    products = _Products(monkeypatch)
    mixed = srv.predict(keys, dense)
    n = len(products.exact)
    assert n >= 2 and all(products.exact), products.exact
    tps.get_model_params(family).use_mixed_precision = False
    f32 = tserver(tps.get_model_params(family), tps.get_embedding_cache(family, 0),
                  model).predict(keys, dense)
    assert not all(products.exact[n:])
    assert not torch.equal(mixed, f32)


def test_mixed_precision_dcn_vs_jax(zoo):
    """DCN-v2 with use_mixed_precision in both packages' ps.json: within
    1e-2 * max|logit| of the JAX server (f32 products on the CPU)."""
    root, _, _, _ = zoo
    jps, tps = _create({"models": [_model_cfg(root, "dcn", use_mixed_precision=True)]})
    fm, params, model = _carried("dcn", seed=6)
    jsrv = jprog.make_dcn_server(jps.get_model_params("dcn"), jps.get_embedding_cache("dcn", 0),
                                 fm, params)
    tsrv = tprog.make_dcn_server(tps.get_model_params("dcn"), tps.get_embedding_cache("dcn", 0),
                                 model)
    rng = np.random.default_rng(7)
    keys = _keys(zoo, "dcn", rng, b=64)
    dense = rng.standard_normal((64, ND)).astype(np.float32)
    want = np.asarray(jsrv.predict(keys, dense))
    got = tsrv.predict(keys, dense).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_wdl_wide_term_is_the_sum_of_wide_rows(zoo):
    """The wide part adds the sum of its scalar rows: moving the wide keys
    to misses (default row 0) takes exactly that off the logits."""
    _, _, _, tps = zoo
    _, _, model = _carried("wdl")
    cache = tps.get_embedding_cache("wdl", 0)
    srv = tprog.make_wdl_server(tps.get_model_params("wdl"), cache, model)
    rng = np.random.default_rng(8)
    wkeys, dkeys = _keys(zoo, "wdl", rng)
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    logits = srv.predict([wkeys, dkeys], dense).numpy()
    nowide = srv.predict([np.full((B, 2), -1, np.int64), dkeys], dense).numpy()
    wide = cache.lookup([wkeys.reshape(-1), dkeys.reshape(-1)])[0].numpy()
    wide = wide.reshape(B, 2).sum(axis=1)
    np.testing.assert_allclose(logits - nowide, wide, rtol=1e-4, atol=1e-5)


def test_deepfm_fm_term_is_the_pairwise_sum():
    """DeepFM's FM term equals its O(T^2) pairwise definition: the model
    with a zero deep MLP and zero first-order weights gives the FM term."""
    model = tmodels.DeepFM(2, 5, 8, deep_widths=(4, 1))
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((6, 5, 8)).astype(np.float32)
    with torch.no_grad():
        fm = model(torch.zeros(6, 2), torch.zeros(6, 5, 1), torch.from_numpy(emb)).numpy()
    pair = sum((emb[:, i] * emb[:, j]).sum(-1) for i in range(5) for j in range(i + 1, 5))
    np.testing.assert_allclose(fm, pair, rtol=1e-4, atol=1e-5)


def test_cin_layer_is_the_pairwise_definition():
    """CINLayer == einsum("ght,bhd,btd->bgd") over w [G, H, T], and matches
    the Flax layer on its weights."""
    rng = np.random.default_rng(10)
    x0 = rng.standard_normal((4, 3, 8)).astype(np.float32)
    x = rng.standard_normal((4, 5, 8)).astype(np.float32)
    flax_layer = FlaxCIN(feature_maps=6)
    lp = flax_layer.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x0))
    layer = CINLayer(5, 3, 6)
    layer.load_state_dict({"w": torch.from_numpy(np.array(lp["params"]["w"]))})
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(x0)).numpy()
    w = np.asarray(lp["params"]["w"]).reshape(6, 5, 3)
    np.testing.assert_allclose(got, np.einsum("ght,bhd,btd->bgd", w, x, x0),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(flax_layer.apply(lp, x, x0)),
                               rtol=1e-4, atol=1e-5)


def test_mmoe_gates_mix_experts():
    """MMoE's tasks see their own gates and towers: [B, K] logits that
    differ between tasks (the JAX package's test, on carried weights)."""
    fm = jmodels.MMoE(num_experts=4, num_tasks=3, expert_widths=(16, 8), tower_widths=(8, 1))
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((4, 2)).astype(np.float32)
    emb = rng.standard_normal((4, 3, 8)).astype(np.float32)
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(dense), jnp.asarray(emb))
    model = tmodels.MMoE(2, 3, 8, num_experts=4, num_tasks=3, expert_widths=(16, 8),
                         tower_widths=(8, 1))
    model.load_state_dict(tmodels.load_flax_mmoe_params(jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    with torch.no_grad():
        y = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    assert y.shape == (4, 3) and np.isfinite(y).all()
    assert np.abs(y[:, 0] - y[:, 1]).max() > 1e-6
    np.testing.assert_allclose(y, np.asarray(fm.apply(params, dense, emb)), rtol=1e-4,
                               atol=1e-5)


def test_init_flax_is_seeded():
    """init_flax_ draws every parameter from the generator (same seed, same
    weights; no parameter left uninitialised) for each family."""
    for family in FAMILIES:
        tmodel = FAMILIES[family][4]
        a = tmodel().init_flax_(torch.Generator().manual_seed(3))
        b = tmodel().init_flax_(torch.Generator().manual_seed(3))
        for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.isfinite(p).all(), (family, name)
            assert torch.equal(p, q), (family, name)


def _flax_tree(family):
    """A Flax params tree (numpy) of ``family``, small shapes."""
    if family in FAMILIES:
        fm = FAMILIES[family][3]()
        params = fm.init(jax.random.PRNGKey(0), *_flax_inputs(family))
    elif family == "two_tower":
        params = jmodels.TwoTowerUser(widths=(8, 4)).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 1, 4)))
    else:
        fm = (jmodels.DIN(mlp_widths=(8, 1), att_hidden=4) if family == "din"
              else jmodels.BST(num_heads=2, head_widths=(8, 1)))
        params = fm.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 4)),
                         jnp.zeros((2, 5, 4)), jnp.ones((2,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


_LOADERS = {
    "wdl": tmodels.load_flax_wdl_params,
    "dcn": tmodels.load_flax_dcn_params,
    "deepfm": tmodels.load_flax_deepfm_params,
    "xdeepfm": load_flax_xdeepfm_params,
    "ncf": tmodels.load_flax_ncf_params,
    "mmoe": tmodels.load_flax_mmoe_params,
    "din": tmodels.load_flax_din_params,
    "bst": tmodels.load_flax_bst_params,
    "two_tower": tmodels.load_flax_two_tower_params,
}


@pytest.mark.parametrize("family", list(_LOADERS))
def test_load_refuses_unknown_module(family):
    """Each load_flax_<model>_params carries a real Flax tree across and
    raises on a module name it does not know, at the top level and inside
    an MLP."""
    load = _LOADERS[family]
    tree = _flax_tree(family)
    assert load(tree)
    top = {"params": {**tree["params"], "Conv_0": {}}}
    with pytest.raises(ValueError, match="Conv_0"):
        load(top)
    inner = {"params": {**tree["params"],
                        "MLP_0": {**tree["params"]["MLP_0"], "LayerNorm_3": {}}}}
    with pytest.raises(ValueError, match="LayerNorm_3"):
        load(inner)


def test_chip_smoke_zoo_rehearsal(tmp_path, monkeypatch):
    """chip_smoke's zoo phase on the CPU at a small size (4 Criteo tables
    capped at 4,096 rows, D 16; DIN tables of 5,000 rows, batch 64, S 8;
    the per-product split at two small shapes): every part's checks run
    against the CPU instance (the "card" instance is a second CPU instance,
    and K1 is not launched). Each family runs on Flax's initial weights and
    again with its biases drawn (``*_bias``)."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_profile", lambda run, n: (run(), (None, []))[1])
    for name, value in (("ROW_CAP", 4096), ("DIM", 16), ("ZOO_ROWS", 5000),
                        ("ZOO_BATCH", 64), ("ZOO_SEQ", 8), ("ZOO_K", 10), ("ZOO_REF", 32),
                        ("ZOO_REF_RETRIEVE", 16), ("ZOO_SMALL_BATCHES", (8, 64)),
                        ("BF16_PRODUCTS", (("linear", "linear", (64, 205, 64)),
                                           ("bmm", "bmm", (8, 9, 8, 9))))):
        monkeypatch.setattr(cs, name, value)
    # On the card the 1,000,000-row tables are "solo" (host-gathered scales).
    monkeypatch.setenv("HPS_TPU_ARENA_MEMBER_MAX_ROWS", "4096")
    cards = [min(c, cs.ROW_CAP) for c in cs.CRITEO_CARDS[:4]]
    tables, cfg = cs.build_deployment(str(tmp_path), cards, cs.DIM, cs.SEED)
    ps = tpkg.HierParameterServer.create(cfg, device="cpu")
    lines = []
    out = cs.zoo_phase(torch.device("cpu"), ps, cfg, cs.make_batches(tables, 64, 2, cs.SEED),
                       emit_line=lines.append)
    assert out["launches"] == {}
    split = [ln for ln in lines if "bf16_product" in ln]
    assert [ln["bf16_product"] for ln in split] == ["linear", "bmm"] and split == out["split"]
    for ln in split:  # the CPU's repaired product is the reference itself
        assert ln["c_within"] and ln["c_share_differing"] == 0.0 and ln["c_max_ulps"] == 0.0
        assert ln["c_max_ulps_at_cpu"] == 0.0
    assert split[0]["a_share_differing"] > cs.BF16_SPLIT_SHARE and not split[0]["a_within"]
    assert split[0]["a_max_ulps"] is None and split[1]["a_max_ulps"] == 0.0
    assert split[0]["a_max_ulps_at_cpu"] is None and split[1]["a_max_ulps_at_cpu"] == 0.0
    lines = [ln for ln in lines if "zoo" in ln]
    legs = ("", "_bf16", "_bias", "_bias_bf16")
    assert [ln["zoo"] for ln in lines] == (
        [f"dcn_v2{leg}" for leg in legs] + ["din_deploy"]
        + [f + leg for f in ("din", "bst", "retrieval") for leg in legs]
        + [f + leg for f in ("wdl", "deepfm", "dcn_v2_small", "xdeepfm", "ncf", "mmoe")
           for leg in legs for _ in (8, 64)])
    assert lines[4]["kinds"] == ["solo", "solo"]
    for retrieval in [ln for ln in lines if ln["zoo"].startswith("retrieval")]:
        assert retrieval["keys_compared"] > retrieval["positions"] // 4
    assert all(ln["rel_vs_cpu"] == 0.0 for ln in lines if "rel_vs_cpu" in ln)
    bf16 = [ln for ln in lines if ln["zoo"].endswith("_bf16")]
    assert len(bf16) == 2 * (4 + 12) and all(ln["compute_dtype"] == "bfloat16" for ln in bf16)
    assert all(ln["rel_vs_cpu"] < ln["rel_vs_cpu_f32"] and ln["f32_rel_vs_cpu"] > 0
               for ln in bf16)
    assert all(ln["biases"] == ("_bias" in ln["zoo"]) for ln in lines if "biases" in ln)
    timed = [ln for ln in lines[:17] if ln["zoo"] != "din_deploy" and not ln["biases"]]
    assert len(timed) == 8 and all(ln["wall_ms_median"] > 0 for ln in timed)
    assert not any("wall_ms_median" in ln for ln in lines if ln.get("biases"))
