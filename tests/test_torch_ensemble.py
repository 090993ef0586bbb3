"""Ensembles in the PyTorch port (``serving/ensemble.py``, the repository's
dense models, and both front ends) against the JAX package on the same
Triton-style repository: an HPS model (one f32 table, 4 keys a sample, D 16)
chained into a dense model (64 -> 8 relu -> 1 sigmoid), the layout of the
reference's hps-triton-ensemble sample (tests/test_ensemble.py's texts).

Tolerances (those of tests/test_torch_dense_model.py, where they are argued):
- f32 and w8a8 dense models: rtol 1e-5, atol 1e-6 (f32 products of two
  libraries; w8a8's int32 sums are exact on both sides);
- weight-only int8 / fp8: rtol 1e-3, atol 1e-5 (bf16 rounding of a layer's
  input one f32 ulp apart);
- against the numpy MLP on the f32 rows: rtol 1e-5, atol 1e-6 for f32;
- the port's fused path against its staged path: bit-identical for the f32
  and w8a8 models (the same rows and the same dense forward).
Specs, topological orders and errors are equal.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hugectr_backend_tpu.config.params import ConfigError as JaxConfigError
from hugectr_backend_tpu.io.model_repo import load_repository as jload_repository
from hugectr_backend_tpu.io.model_repo import parse_pbtxt
from hugectr_backend_tpu.serving.ensemble import EnsembleServer as JaxEnsembleServer
from hugectr_backend_tpu.serving.ensemble import EnsembleSpec as JaxSpec
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager
from hugectr_backend_tpu.serving.server import HpsHttpServer as JaxHttpServer
from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.io.dense_model import save_dense_model
from hugectr_backend_tpu_torch.io.model_repo import load_repository
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.serving.ensemble import EnsembleServer, EnsembleSpec
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.scheduler import RequestError
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer, serve

DIM = 16
KEYS_PER_SAMPLE = 4
HIDDEN = 8
TIMEOUT = 30
TOL = {None: (1e-5, 1e-6), "w8a8": (1e-5, 1e-6), "int8": (1e-3, 1e-5), "fp8": (1e-3, 1e-5)}

# The exact shape the reference notebook writes (02_…_tf_ensemble.ipynb).
ENSEMBLE_PBTXT = """
name: "ensemble_model"
platform: "ensemble"
max_batch_size: 0
input [
  { name: "EMB_KEY" data_type: TYPE_INT64 dims: [ -1, -1 ] },
  { name: "EMB_N_KEY" data_type: TYPE_INT32 dims: [ -1, -1 ] }
]
output [
  { name: "DENSE_OUTPUT" data_type: TYPE_FP32 dims: [-1, 1] }
]
ensemble_scheduling {
  step [
    {
      model_name: "hps_embedding"
      model_version: -1
      input_map { key: "KEYS" value: "EMB_KEY" }
      input_map { key: "NUMKEYS" value: "EMB_N_KEY" }
      output_map { key: "OUTPUT0" value: "LOOKUP_VECTORS" }
    },
    {
      model_name: "dense_model"
      model_version: -1
      input_map { key: "input_1" value: "LOOKUP_VECTORS" }
      output_map { key: "output_1" value: "DENSE_OUTPUT" }
    }
  ]
}
"""

HPS_PBTXT = """
name: "hps_embedding"
backend: "hps"
max_batch_size: 64
input [
  { name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] },
  { name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }
]
output [ { name: "OUTPUT0" data_type: TYPE_FP32 dims: [ -1 ] } ]
instance_group [ { count: 1 kind: KIND_GPU gpus: [ 0 ] } ]
"""

DENSE_PBTXT = """
name: "dense_model"
platform: "hps_tpu_dense"
max_batch_size: 0
input [ { name: "input_1" data_type: TYPE_FP32 dims: [ -1 ] } ]
output [ { name: "output_1" data_type: TYPE_FP32 dims: [ -1, 1 ] } ]
"""


def _mlp_weights(seed):
    rng = np.random.default_rng(seed)
    in_dim = DIM * KEYS_PER_SAMPLE
    return [((rng.normal(size=(in_dim, HIDDEN)) * 0.1).astype(np.float32),
             (rng.normal(size=(HIDDEN,)) * 0.1).astype(np.float32)),
            ((rng.normal(size=(HIDDEN, 1)) * 0.1).astype(np.float32),
             np.zeros((1,), np.float32))]


def _np_mlp(weights, x):
    (w0, b0), (w1, b1) = weights
    h = np.maximum(x @ w0 + b0, 0.0)
    return 1.0 / (1.0 + np.exp(-(h @ w1 + b1)))


def _build_repo(root, rows=3000, gpucacheper=1.0, cache_type="static", dense_quant=None,
                extra_ps=None, ensemble_pbtxt=ENSEMBLE_PBTXT, seed=1234):
    mdir = root / "hps_embedding"
    mdir.mkdir()
    (mdir / "config.pbtxt").write_text(HPS_PBTXT)
    tbl = make_synthetic_table(rows, DIM, seed=3)
    write_sparse_model(mdir / "1" / "sparse0.model", tbl.keys, tbl.vectors)
    ddir = root / "dense_model"
    ddir.mkdir()
    (ddir / "config.pbtxt").write_text(DENSE_PBTXT)
    weights = _mlp_weights(seed)
    save_dense_model(ddir / "1", weights, ["relu", "sigmoid"],
                     reshape=[-1, DIM * KEYS_PER_SAMPLE], quant=dense_quant)
    edir = root / "ensemble_model"
    (edir / "1").mkdir(parents=True)
    (edir / "config.pbtxt").write_text(ensemble_pbtxt)
    ps = {"models": [{
        "model": "hps_embedding",
        "sparse_files": ["sparse0.model"],
        "embedding_vecsize_per_table": [DIM],
        "maxnum_catfeature_query_per_table_per_sample": [KEYS_PER_SAMPLE],
        "max_batch_size": 64,
        "gpucacheper": gpucacheper,
        "embedding_cache_type": cache_type,
        "quant_bits": 32,
        **(extra_ps or {}),
    }]}
    (root / "ps.json").write_text(json.dumps(ps))
    return tbl, weights


def _serve_bundle(root, jax=False):
    """-> (bundle, manager, {name: EnsembleServer}) of one package."""
    if jax:
        bundle = jload_repository(root)
        mgr = JaxManager.create(bundle.ps_config, load_all=False)
        server_cls = JaxEnsembleServer
    else:
        bundle = load_repository(root, device="cpu")
        mgr = ModelManager.create(bundle.ps_config, load_all=False, device="cpu")
        server_cls = EnsembleServer
    for name, v in bundle.hps_versions.items():
        mgr.load(name, version=v)
    return bundle, mgr, {n: server_cls(s, mgr, bundle.dense)
                         for n, s in bundle.ensembles.items()}


def _inputs(keys):
    return {"EMB_KEY": np.asarray(keys, np.int64),
            "EMB_N_KEY": np.asarray([len(keys)], np.int32)}


# ------------------------------------------------------------------- parsing


def _spec_cases():
    def as_is(cfg):
        pass

    def reversed_steps(cfg):
        cfg["ensemble_scheduling"]["step"].reverse()

    def ghost_input(cfg):
        cfg["ensemble_scheduling"]["step"][0]["input_map"][0]["value"] = "GHOST"

    def missing_output(cfg):
        cfg["output"][0]["name"] = "MISSING"

    def cycle(cfg):
        steps = cfg["ensemble_scheduling"]["step"]
        steps[0]["input_map"][0]["value"] = "DENSE_OUTPUT"

    def not_ensemble(cfg):
        cfg["platform"] = "hps"

    def no_steps(cfg):
        cfg["ensemble_scheduling"] = {}

    def no_output_map(cfg):
        del cfg["ensemble_scheduling"]["step"][1]["output_map"]

    def no_model_name(cfg):
        del cfg["ensemble_scheduling"]["step"][1]["model_name"]

    def bad_map(cfg):
        cfg["ensemble_scheduling"]["step"][1]["input_map"] = {"key": "input_1"}

    return {f.__name__: f for f in (as_is, reversed_steps, ghost_input, missing_output, cycle,
                                    not_ensemble, no_steps, no_output_map, no_model_name,
                                    bad_map)}


@pytest.mark.parametrize("case", sorted(_spec_cases()))
def test_spec_topo_and_errors_identical(case):
    def cfg():
        c = parse_pbtxt(ENSEMBLE_PBTXT)
        _spec_cases()[case](c)
        return c

    try:
        want = dataclasses.asdict(JaxSpec.from_config("e", cfg()))
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            EnsembleSpec.from_config("e", cfg())
        assert str(got.value) == str(e)
        assert case not in ("as_is", "reversed_steps")
        return
    got = dataclasses.asdict(EnsembleSpec.from_config("e", cfg()))
    assert got == want
    assert [s["model_name"] for s in got["steps"]] == ["hps_embedding", "dense_model"]
    assert got["steps"][0]["input_map"] == {"KEYS": "EMB_KEY", "NUMKEYS": "EMB_N_KEY"}
    assert got["outputs"][0]["datatype"] == "FP32"


# ----------------------------------------------------------------------- e2e


def test_fused_matches_staged_and_numpy(tmp_path, monkeypatch):
    """The fused path engages, runs one grouped gather per infer and hands a
    tensor (no host copy) to the dense model; it equals the staged path bit
    for bit and the numpy MLP on the f32 rows."""
    tbl, weights = _build_repo(tmp_path)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    calls = []
    real = lookup_program.gather_dequant_groups
    monkeypatch.setattr(lookup_program, "gather_dequant_groups",
                        lambda *a: calls.append(a) or real(*a))
    dm = bundle.dense["dense_model"]
    seen = []
    real_apply = dm.apply
    monkeypatch.setattr(dm, "apply", lambda x: seen.append(type(x)) or real_apply(x))
    try:
        es = ensembles["ensemble_model"]
        b = 6
        keys = tbl.keys[: b * KEYS_PER_SAMPLE].astype(np.int64)
        out = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        assert es._fused is not None and len(calls) == 1 and seen == [torch.Tensor]
        assert out.shape == (b, 1) and out.dtype == np.float32
        x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
        np.testing.assert_allclose(out, _np_mlp(weights, x), rtol=1e-5, atol=1e-6)
        staged = es.infer_staged(_inputs(keys))["DENSE_OUTPUT"]
        np.testing.assert_array_equal(staged.reshape(out.shape), out)
    finally:
        mgr.shutdown()


def test_lookup_gathers_no_bucket_pad(tmp_path, monkeypatch):
    """``lookup_flat`` and ``lookup`` gather exactly the rows asked for (the
    caller's ``pad_counts`` included) and no power-of-two bucket past them:
    K1's work on the fused path is the ensemble's b_pad * k slots."""
    tbl, _ = _build_repo(tmp_path)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    calls = []
    real = lookup_program.gather_dequant_groups
    monkeypatch.setattr(lookup_program, "gather_dequant_groups",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    try:
        cache = mgr.ps.get_embedding_cache("hps_embedding", 0)
        keys = tbl.keys[:25].astype(np.int64)
        flat = cache.lookup_flat([keys], pad_counts=[40])
        (rows,) = cache.lookup([keys])
        assert calls == [40, 25]
        np.testing.assert_array_equal(flat.reshape(40, DIM)[:25].numpy(), rows.numpy())
        np.testing.assert_array_equal(rows.numpy(), expected_vector(keys, DIM))
        np.testing.assert_array_equal(flat.reshape(40, DIM)[25:].numpy(), 0.0)
        b = 6
        ensembles["ensemble_model"].infer(_inputs(tbl.keys[: b * KEYS_PER_SAMPLE]))
        assert calls[2:] == [8 * KEYS_PER_SAMPLE]
    finally:
        mgr.shutdown()


def test_fused_hit_meter_counts_real_keys_once(tmp_path, monkeypatch):
    """b * k lookups and their misses are counted once; the pad rows of the
    bucket (6 samples -> 8) are neither lookups nor misses."""
    tbl, weights = _build_repo(tmp_path)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    try:
        es = ensembles["ensemble_model"]
        b = 6
        keys = tbl.keys[: b * KEYS_PER_SAMPLE].astype(np.int64).copy()
        keys[:3] = [-5, 10**12, -7]  # absent everywhere: default rows
        cache = mgr.ps.get_embedding_cache("hps_embedding", 0)
        updates = []
        monkeypatch.setattr(cache.hit_meter, "update", lambda *a: updates.append(a))
        out = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        assert es._fused is not None
        assert updates == [(0, b * KEYS_PER_SAMPLE - 3, b * KEYS_PER_SAMPLE)]
        x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
        x.reshape(-1, DIM)[:3] = 0.0
        np.testing.assert_allclose(out, _np_mlp(weights, x), rtol=1e-5, atol=1e-6)
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("fmt", [None, "int8", "fp8", "w8a8"])
def test_fused_matches_jax(tmp_path, fmt):
    """The port's fused ensemble against the JAX package's on the same
    repository, for each dense format."""
    tbl, weights = _build_repo(tmp_path, dense_quant=fmt)
    rtol, atol = TOL[fmt]
    rng = np.random.default_rng(5)
    requests = [tbl.keys[rng.choice(len(tbl.keys), b * KEYS_PER_SAMPLE)].astype(np.int64)
                for b in (1, 5, 64)]
    outs = []
    for jax in (True, False):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        try:
            es = ensembles["ensemble_model"]
            outs.append([np.asarray(es.infer(_inputs(k))["DENSE_OUTPUT"]) for k in requests])
            assert es._fused is not None
        finally:
            mgr.shutdown()
    for want, got in zip(*outs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_ragged_request_goes_staged(tmp_path, monkeypatch):
    """With a dense model that scores each key (reshape [-1, D]), a request
    whose key count is not a multiple of k is served staged, and matches
    the JAX package and the numpy MLP; a whole request is served fused."""
    tbl, _ = _build_repo(tmp_path)
    rng = np.random.default_rng(9)
    weights = [((rng.normal(size=(DIM, HIDDEN)) * 0.1).astype(np.float32),
                (rng.normal(size=(HIDDEN,)) * 0.1).astype(np.float32)),
               ((rng.normal(size=(HIDDEN, 1)) * 0.1).astype(np.float32),
                np.zeros((1,), np.float32))]
    save_dense_model(tmp_path / "dense_model" / "1", weights, ["relu", "sigmoid"],
                     reshape=[-1, DIM])
    outs = []
    for jax in (True, False):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        es = ensembles["ensemble_model"]
        staged = []
        real = es.infer_staged
        monkeypatch.setattr(es, "infer_staged", lambda t: staged.append(1) or real(t))
        try:
            outs.append([es.infer(_inputs(tbl.keys[:n].astype(np.int64)))["DENSE_OUTPUT"]
                         for n in (7, 8)])
            assert es._fused is not None and len(staged) == 1
        finally:
            mgr.shutdown()
    for n, want, got in zip((7, 8), *outs):
        assert got.shape == want.shape == (n, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        x = expected_vector(tbl.keys[:n], DIM)
        np.testing.assert_allclose(got, _np_mlp(weights, x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["int8", "fp8", "w8a8"])
def test_fused_quantized_dense_matches_staged(tmp_path, fmt):
    tbl, weights = _build_repo(tmp_path, dense_quant=fmt)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    try:
        es = ensembles["ensemble_model"]
        b = 5
        keys = tbl.keys[: b * KEYS_PER_SAMPLE].astype(np.int64)
        out = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        assert es._fused is not None
        staged = es.infer_staged(_inputs(keys))["DENSE_OUTPUT"]
        np.testing.assert_array_equal(staged.reshape(out.shape), out)
        x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
        np.testing.assert_allclose(out, _np_mlp(weights, x), rtol=0.1, atol=0.05)
    finally:
        mgr.shutdown()


def test_partial_cache_uses_staged_path(tmp_path):
    """gpucacheper < 1: a device miss may live in DRAM, so the chain must
    not fuse; the staged path serves the tier rows."""
    tbl, weights = _build_repo(tmp_path, gpucacheper=0.5, cache_type="dynamic")
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    try:
        es = ensembles["ensemble_model"]
        b = 4
        keys = tbl.keys[-b * KEYS_PER_SAMPLE:].astype(np.int64)
        out = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        assert es._fused is None and es._fused_ready
        x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
        np.testing.assert_allclose(out.reshape(b, 1), _np_mlp(weights, x), rtol=1e-5,
                                   atol=1e-6)
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("case", ["missing_input", "unknown_step", "over_max_batch",
                                  "empty"])
def test_request_errors_identical(tmp_path, case):
    pbtxt = ENSEMBLE_PBTXT
    if case == "unknown_step":
        pbtxt = pbtxt.replace('model_name: "dense_model"', 'model_name: "ghost_model"')
    tbl, _ = _build_repo(tmp_path, ensemble_pbtxt=pbtxt)
    inputs = {
        "missing_input": {"EMB_KEY": np.asarray([1, 2, 3, 4], np.int64)},
        "unknown_step": _inputs(tbl.keys[:8]),
        "over_max_batch": _inputs(np.resize(tbl.keys, 65 * KEYS_PER_SAMPLE)),
        "empty": _inputs(np.zeros(0, np.int64)),
    }[case]
    msgs = []
    for jax in (True, False):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        try:
            with pytest.raises(Exception) as e:
                ensembles["ensemble_model"].infer(dict(inputs))
            assert type(e.value).__name__ == "RequestError"
            msgs.append(str(e.value))
        finally:
            mgr.shutdown()
    assert msgs[1] == msgs[0]
    if case == "missing_input":
        assert "missing input" in msgs[1]


def test_fused_tracks_reload(tmp_path):
    """After unload the fused path must not keep serving the destroyed
    cache's rows; after a reload it serves the new cache."""
    tbl, weights = _build_repo(tmp_path)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)
    try:
        es = ensembles["ensemble_model"]
        keys = tbl.keys[: 3 * KEYS_PER_SAMPLE].astype(np.int64)
        out1 = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        assert es._fused is not None
        old_cache = mgr.ps.get_embedding_cache("hps_embedding", 0)
        mgr.unload("hps_embedding")
        with pytest.raises(RequestError, match="not loaded"):
            es.infer(_inputs(keys))  # the staged path reports it
        mgr.load("hps_embedding")
        assert mgr.ps.get_embedding_cache("hps_embedding", 0) is not old_cache
        out2 = es.infer(_inputs(keys))["DENSE_OUTPUT"]
        np.testing.assert_array_equal(out2, out1)
    finally:
        mgr.shutdown()


def test_instance_group_cannot_shrink_sharded_mesh(tmp_path):
    _build_repo(tmp_path, extra_ps={"shard_tables": True,
                                    "deployed_device_list": [0, 1, 2, 3]})
    with pytest.raises(JaxConfigError) as want:
        jload_repository(tmp_path)
    with pytest.raises(ConfigError, match="shard_tables needs >= 2") as got:
        load_repository(tmp_path, device="cpu")
    assert str(got.value) == str(want.value)


SHARDED_HPS_PBTXT = HPS_PBTXT.replace("gpus: [ 0 ]", "gpus: [ 0, 1, 2, 3, 4, 5, 6, 7 ]")


def _sharded_repo(tmp_path):
    tbl, weights = _build_repo(tmp_path, extra_ps={
        "shard_tables": True, "deployed_device_list": [0, 1, 2, 3, 4, 5, 6, 7]})
    (tmp_path / "hps_embedding" / "config.pbtxt").write_text(SHARDED_HPS_PBTXT)
    return tbl, weights


def test_sharded_fused_branch_refuses_naming_item_7(tmp_path, monkeypatch):
    """(Named for the refusal it pinned until the port had parallel/.) A
    SHARDED HPS model runs the fused chain: one K1 call per device of its
    mesh (one here: 8 shards on the host) feeds the dense model, against the
    JAX package's fused sharded ensemble (tests/test_ensemble.py::
    test_ensemble_fused_sharded) within the f32 tolerance, the port's staged
    path bit for bit, and the numpy MLP; misses serve default rows."""
    from hugectr_backend_tpu_torch.parallel import sharded_table
    from hugectr_backend_tpu_torch.parallel.sharded_cache import ShardedEmbeddingCache

    tbl, weights = _sharded_repo(tmp_path)
    b = 6
    keys = tbl.keys[: b * KEYS_PER_SAMPLE].astype(np.int64)
    km = keys.copy()
    km[:KEYS_PER_SAMPLE] = -999
    outs = []
    calls = []
    real = sharded_table.gather_dequant_groups
    monkeypatch.setattr(sharded_table, "gather_dequant_groups",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    for jax in (True, False):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        try:
            es = ensembles["ensemble_model"]
            calls.clear()
            got = [es.infer(_inputs(k))["DENSE_OUTPUT"] for k in (keys, km)]
            outs.append(got)
            if jax:
                assert es._fused is not None and es._fused[0] == "sharded"
                continue
            assert isinstance(mgr.ps.get_embedding_cache("hps_embedding", 0),
                              ShardedEmbeddingCache)
            assert es._fused is not None and es._fused.sharded and calls == [8, 8]
            staged = es.infer_staged(_inputs(keys))["DENSE_OUTPUT"]
            np.testing.assert_array_equal(staged.reshape(got[0].shape), got[0])
        finally:
            mgr.shutdown()
    x = expected_vector(keys, DIM).reshape(b, DIM * KEYS_PER_SAMPLE)
    xm = x.copy()
    xm[0, : KEYS_PER_SAMPLE * DIM] = 0.0
    for want, got, ref in zip(*outs, (x, xm)):
        assert got.shape == want.shape == (b, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, _np_mlp(weights, ref), rtol=1e-5, atol=1e-6)


def test_failed_fused_build_raises_on_every_infer(tmp_path):
    """A fused build that raised has decided nothing: every later infer
    builds again and raises again, instead of serving staged. The build is
    made to fail by a dense model whose layout cannot be read."""
    _build_repo(tmp_path)
    bundle, mgr, ensembles = _serve_bundle(tmp_path)

    class _Unreadable:
        def __init__(self, dm):
            self._dm = dm

        @property
        def reshape(self):
            raise RuntimeError("dense model layout unreadable")

        def __getattr__(self, name):
            return getattr(self._dm, name)

    try:
        es = ensembles["ensemble_model"]
        es.dense["dense_model"] = _Unreadable(es.dense["dense_model"])
        for _ in range(3):
            with pytest.raises(RuntimeError, match="layout unreadable"):
                es.infer(_inputs(np.arange(8, dtype=np.int64)))
            assert es._fused is None and not es._fused_ready
    finally:
        mgr.shutdown()


def test_dense_model_follows_the_hps_instance(tmp_path):
    """Dense models load where their ensemble's HPS instance serves: the CPU
    when asked for; without a card the default (the card) raises."""
    _build_repo(tmp_path)
    bundle = load_repository(tmp_path, device="cpu")
    assert bundle.dense["dense_model"].device.type == "cpu"
    assert bundle.dense["dense_model"].input_name == "input_1"
    assert bundle.dense["dense_model"].output_name == "output_1"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_repository(tmp_path)


# ------------------------------------------------------------------ front ends


def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def http_pair(tmp_path):
    tbl, weights = _build_repo(tmp_path)
    servers = []
    for jax, cls in ((True, JaxHttpServer), (False, HpsHttpServer)):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        servers.append(cls(mgr, port=0, ensembles=ensembles,
                           dense_models=bundle.dense).start())
    yield tbl, weights, servers
    for s in servers:
        s.stop()


def _json_body(keys):
    return json.dumps({"inputs": [
        {"name": "EMB_KEY", "datatype": "INT64", "shape": [len(keys)],
         "data": [int(k) for k in keys]},
        {"name": "EMB_N_KEY", "datatype": "INT32", "shape": [1], "data": [len(keys)]},
    ]}).encode()


def _binary_body(keys):
    kraw = np.ascontiguousarray(keys, "<i8").tobytes()
    nraw = np.asarray([len(keys)], "<i4").tobytes()
    hdr = json.dumps({
        "inputs": [
            {"name": "EMB_KEY", "datatype": "INT64", "shape": [len(keys)],
             "parameters": {"binary_data_size": len(kraw)}},
            {"name": "EMB_N_KEY", "datatype": "INT32", "shape": [1],
             "parameters": {"binary_data_size": len(nraw)}},
        ],
        "outputs": [{"name": "DENSE_OUTPUT", "parameters": {"binary_data": True}}],
    }).encode()
    return hdr + kraw + nraw, {"Inference-Header-Content-Length": str(len(hdr))}


@pytest.mark.parametrize("samples", [1, 3, 64])
def test_http_json_and_binary_vs_jax(http_pair, samples):
    tbl, weights, (jsrv, tsrv) = http_pair
    keys = tbl.keys[: samples * KEYS_PER_SAMPLE].astype(np.int64)
    x = expected_vector(keys, DIM).reshape(samples, DIM * KEYS_PER_SAMPLE)
    want = _np_mlp(weights, x)
    # JSON: the same header, the same shapes, data within the f32 tolerance.
    (js, _, jb), (ts, _, tb) = (_post(s.port, "/v2/models/ensemble_model/infer",
                                      _json_body(keys)) for s in (jsrv, tsrv))
    assert js == ts == 200
    jr, tr = json.loads(jb), json.loads(tb)
    jdata, tdata = jr["outputs"][0].pop("data"), tr["outputs"][0].pop("data")
    assert tr == jr and tr["outputs"][0]["shape"] == [samples, 1]
    np.testing.assert_allclose(tdata, jdata, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.reshape(tdata, (samples, 1)), want, rtol=1e-5, atol=1e-6)
    # Binary: the same header bytes, the payload within the same tolerance.
    body, headers = _binary_body(keys)
    got = [_post(s.port, "/v2/models/ensemble_model/infer", body, headers)
           for s in (jsrv, tsrv)]
    hl = [int(h["Inference-Header-Content-Length"]) for _, h, _ in got]
    assert got[0][0] == got[1][0] == 200 and hl[0] == hl[1]
    assert got[1][2][: hl[1]] == got[0][2][: hl[0]]
    jout, tout = (np.frombuffer(r[2][h:], "<f4") for r, h in zip(got, hl))
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method, path", [
    ("GET", "/v2/models/ensemble_model"), ("GET", "/v2/models/ensemble_model/config"),
    ("GET", "/v2/models/ensemble_model/ready"), ("GET", "/v2/models/dense_model"),
    ("GET", "/v2/models/dense_model/config"), ("GET", "/v2/models/dense_model/ready"),
    ("GET", "/v2/models/hps_embedding/config"), ("POST", "/v2/repository/index"),
    ("GET", "/v2/models/nothing/ready"),
])
def test_http_metadata_identical(http_pair, method, path):
    _, _, (jsrv, tsrv) = http_pair
    if method == "GET":
        got = [_get(s.port, path) for s in (jsrv, tsrv)]
    else:
        got = [_post(s.port, path, b"")[::2] for s in (jsrv, tsrv)]
    assert got[1] == got[0]


def test_http_dense_model_and_bad_requests_vs_jax(http_pair):
    tbl, weights, (jsrv, tsrv) = http_pair
    x = expected_vector(tbl.keys[:KEYS_PER_SAMPLE], DIM).reshape(1, -1)
    dreq = json.dumps({"inputs": [{"name": "input_1", "datatype": "FP32",
                                   "shape": [1, DIM * KEYS_PER_SAMPLE],
                                   "data": x[0].tolist()}]}).encode()
    (js, _, jb), (ts, _, tb) = (_post(s.port, "/v2/models/dense_model/infer", dreq)
                                for s in (jsrv, tsrv))
    assert js == ts == 200
    jr, tr = json.loads(jb), json.loads(tb)
    jdata, tdata = jr["outputs"][0].pop("data"), tr["outputs"][0].pop("data")
    assert tr == jr
    np.testing.assert_allclose(tdata, jdata, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.reshape(tdata, (1, 1)), _np_mlp(weights, x), rtol=1e-5,
                               atol=1e-6)
    for body in (b"{bad json", json.dumps({"inputs": [
            {"name": "EMB_KEY", "datatype": "INT64", "shape": [-1], "data": [1]}]}).encode(),
            json.dumps({"inputs": [{"name": "EMB_KEY", "datatype": "INT64", "shape": [1],
                                    "data": [1]}]}).encode()):
        got = [_post(s.port, "/v2/models/ensemble_model/infer", body)[::2]
               for s in (jsrv, tsrv)]
        assert got[1] == got[0] and got[1][0] == 400


def test_grpc_model_infer_on_the_ensemble(tmp_path):
    """gRPC ModelInfer / ModelReady / ModelMetadata / RepositoryIndex for the
    ensemble and the dense model, port against JAX."""
    grpc = pytest.importorskip("grpc")
    from hugectr_backend_tpu.serving.grpc_server import HpsGrpcServer as JaxGrpcServer
    from hugectr_backend_tpu_torch.serving import kserve_pb
    from hugectr_backend_tpu_torch.serving.grpc_server import HpsGrpcServer

    pb2 = kserve_pb.load()
    tbl, weights = _build_repo(tmp_path)
    servers, managers = [], []
    for jax, cls in ((True, JaxGrpcServer), (False, HpsGrpcServer)):
        bundle, mgr, ensembles = _serve_bundle(tmp_path, jax=jax)
        managers.append(mgr)
        servers.append(cls(mgr, port=0, ensembles=ensembles,
                           dense_models=bundle.dense).start())
    keys = tbl.keys[: 3 * KEYS_PER_SAMPLE].astype(np.int64)
    req = pb2.ModelInferRequest(
        model_name="ensemble_model", id="r1",
        inputs=[pb2.ModelInferRequest.InferInputTensor(
                    name="EMB_KEY", datatype="INT64", shape=[len(keys)]),
                pb2.ModelInferRequest.InferInputTensor(
                    name="EMB_N_KEY", datatype="INT32", shape=[1])],
        raw_input_contents=[keys.astype("<i8").tobytes(),
                            np.asarray([len(keys)], "<i4").tobytes()])
    calls = {
        "ModelInfer": (req, pb2.ModelInferResponse),
        "ModelReady": (pb2.ModelReadyRequest(name="ensemble_model"), pb2.ModelReadyResponse),
        "ModelMetadata": (pb2.ModelMetadataRequest(name="ensemble_model"),
                          pb2.ModelMetadataResponse),
        "DenseMetadata": (pb2.ModelMetadataRequest(name="dense_model"),
                          pb2.ModelMetadataResponse),
        "RepositoryIndex": (pb2.RepositoryIndexRequest(), pb2.RepositoryIndexResponse),
    }
    try:
        got = []
        for srv in servers:
            with grpc.insecure_channel(f"127.0.0.1:{srv.port}") as ch:
                answers = {}
                for name, (msg, resp_cls) in calls.items():
                    method = "ModelMetadata" if name == "DenseMetadata" else name
                    fn = ch.unary_unary(f"/{kserve_pb.SERVICE_NAME}/{method}",
                                        request_serializer=lambda m: m.SerializeToString(),
                                        response_deserializer=resp_cls.FromString)
                    answers[name] = fn(msg, timeout=TIMEOUT)
                got.append(answers)
        jinf, tinf = got[0].pop("ModelInfer"), got[1].pop("ModelInfer")
        assert got[1] == got[0] and got[1]["ModelReady"].ready
        jout = np.frombuffer(jinf.raw_output_contents[0], "<f4")
        tout = np.frombuffer(tinf.raw_output_contents[0], "<f4")
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
        x = expected_vector(keys, DIM).reshape(3, -1)
        np.testing.assert_allclose(tout.reshape(3, 1), _np_mlp(weights, x), rtol=1e-5,
                                   atol=1e-6)
        del jinf.raw_output_contents[:]
        del tinf.raw_output_contents[:]
        assert tinf == jinf
    finally:
        for s in servers:
            s.stop()
        for m in managers:
            m.shutdown()


def test_server_boot_from_repo_with_ensemble(tmp_path):
    """serve(model_repository=...) wires the ensemble without a ps_json
    argument, HTTP and gRPC."""
    tbl, weights = _build_repo(tmp_path)
    grpc_port = 0 if _has_grpc() else None
    server = serve(model_repository=tmp_path, port=0, block=False, grpc_port=grpc_port,
                   device="cpu")
    try:
        assert _get(server.port, "/v2/models/ensemble_model/ready")[0] == 200
        keys = tbl.keys[:KEYS_PER_SAMPLE * 2].astype(np.int64)
        status, _, body = _post(server.port, "/v2/models/ensemble_model/infer",
                                _json_body(keys))
        assert status == 200
        out = np.asarray(json.loads(body)["outputs"][0]["data"], np.float32).reshape(2, 1)
        x = expected_vector(keys, DIM).reshape(2, -1)
        np.testing.assert_allclose(out, _np_mlp(weights, x), rtol=1e-5, atol=1e-6)
        if grpc_port is not None:
            assert server.grpc.service.ensembles.keys() == {"ensemble_model"}
    finally:
        server.stop()


def _has_grpc() -> bool:
    try:
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def test_chip_smoke_ensemble_rehearsal(tmp_path, monkeypatch):
    """chip_smoke's ensemble phase on the CPU at a small size (4 tables
    capped at 4,096 rows, D 16, TOP 64-32-1, batch 64): every check runs over
    the EnsembleServer, HTTP JSON and binary and gRPC (where grpcio is
    installed); no kernel is launched on the CPU."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "TOP", (64, 32, 1))
    monkeypatch.setattr(cs, "ENS_TIMED", 2)
    monkeypatch.setattr(cs, "ENS_HTTP_REQUESTS", 10)
    cards = [min(c, 4096) for c in cs.CRITEO_CARDS[:4]]
    tables, _ = cs.build_deployment(str(tmp_path), cards, 16, cs.SEED)
    lines = []
    out = cs.ensemble_phase(torch.device("cpu"), tables, emit_line=lines.append, batch=64,
                            grpc=_has_grpc())
    assert out["launches"] == {} and out["k1"] is None
    by = {ln["ensemble"]: ln for ln in lines}
    assert set(by) == {"deploy", "ens_f32", "ens_w8a8", "ens_int8", "ens_fp8",
                       "ens_per_key", "http_latency"}
    assert by["deploy"]["table_rows"] == sum(cards) and by["deploy"]["groups"] == ["arena"]
    for fmt in cs.ENS_FORMATS:
        line = by[f"ens_{fmt}"]
        assert line["fused"]["wall_ms_median"] > 0 and line["staged"]["runs"] == 2
        assert ("grpc_vs_host" in line["max_abs_err"]) == _has_grpc()
    assert by["http_latency"]["requests"] == 10
