"""Config-driven sharded serving in the PyTorch port: ps.json ``shard_tables``
deploys the tables row-sharded over a mesh THROUGH the serving stack
(ModelManager -> ContinuousBatcher -> ShardedEmbeddingCache), HTTP included,
against the JAX package on its 8 virtual CPU devices: the cases of
tests/test_sharded_serving.py. The port runs with ``device="cpu"`` (every
``deployed_device_list`` id on the host: 8 shards of one process).

Tolerance: none. Outputs and refresh counts are identical, HTTP responses
byte for byte (both packages quantize the same rows the same way, translate
keys to the same slots and dequantize with one f32 multiply; a sharded
lookup adds exact zeros at most). Config errors carry the same messages.
"""

import json
import urllib.request

import numpy as np
import pytest

from hugectr_backend_tpu.config.params import ConfigError as JConfigError
from hugectr_backend_tpu.config.params import InferenceParams as JParams
from hugectr_backend_tpu.ps.parameter_server import table_tag as jtable_tag
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager
from hugectr_backend_tpu.serving.server import HpsHttpServer as JaxHttpServer
from hugectr_backend_tpu_torch.config.params import ConfigError, InferenceParams
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.parallel.sharded_cache import ShardedEmbeddingCache
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer
from hugectr_backend_tpu_torch.tiers.base import table_tag

TIMEOUT = 30


def _model_cfg(root, name, dims, extra):
    cfg = {
        "model": name,
        "sparse_files": [str(root / f"{name}_t{t}") for t in range(len(dims))],
        "embedding_vecsize_per_table": list(dims),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(dims),
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "shard_tables": True,
        "deployed_device_list": [0, 1, 2, 3, 4, 5, 6, 7],
    }
    cfg.update(extra)
    return cfg


def _managers(cfg):
    """-> (JAX manager, port manager) over one ps.json."""
    text = json.dumps(cfg)
    jm = JaxManager.create(text)
    try:
        return jm, ModelManager.create(text, device="cpu")
    except BaseException:
        jm.shutdown()
        raise


def _infer_both(jm, tm, name, keys, num):
    got = np.asarray(tm.infer(name, keys, np.asarray(num)).output)
    want = np.asarray(jm.infer(name, keys, np.asarray(num)).output)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    return got


_BASE = dict(model="m", sparse_files=["x"], embedding_vecsize_per_table=[8],
             maxnum_catfeature_query_per_table_per_sample=[1],
             embedding_cache_type="static", gpucacheper=1.0)
_BAD = {
    "partial residency": {"shard_tables": True, "gpucacheper": 0.5,
                          "deployed_device_list": [0, 1]},
    "one shard": {"shard_tables": True, "deployed_device_list": [0]},
    "num_shards past the devices": {"shard_tables": True, "num_shards": 4,
                                    "deployed_device_list": [0, 1]},
    "bad strategy": {"shard_tables": True, "shard_strategy": "rpc",
                     "deployed_device_list": [0, 1]},
    "fp8": {"shard_tables": True, "fp8_quant": True, "deployed_device_list": [0, 1]},
    "dynamic": {"shard_tables": True, "deployed_device_list": [0, 1],
                "embedding_cache_type": "dynamic"},
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_config_validation(case):
    with pytest.raises(JConfigError) as want:
        JParams.from_json({**_BASE, **_BAD[case]})
    with pytest.raises(ConfigError) as got:
        InferenceParams.from_json({**_BASE, **_BAD[case]})
    assert str(got.value) == str(want.value)


def test_config_instance_and_shard_devices():
    p = InferenceParams.from_json({**_BASE, "shard_tables": True,
                                   "deployed_device_list": [0, 1, 2]})
    assert p.instance_devices == [0] and p.shard_devices == [0, 1, 2]
    p2 = InferenceParams.from_json({**_BASE, "shard_tables": True, "num_shards": 2,
                                    "deployed_device_list": [0, 1, 2]})
    assert p2.shard_devices == [0, 1]


def test_quantized_default_value_refused_at_deploy(tmp_path):
    """A sharded int8 table with a non-zero default value is refused when the
    cache is built, with the JAX package's ConfigError message."""
    tbl = make_synthetic_table(50, 8, seed=2)
    write_sparse_model(tmp_path / "d_t0", tbl.keys, tbl.vectors)
    text = json.dumps({"models": [_model_cfg(tmp_path, "d", [8], {
        "quant_bits": 8, "default_value_for_each_table": [1.0]})]})
    with pytest.raises(JConfigError) as want:
        JaxManager.create(text)
    with pytest.raises(ConfigError) as got:
        ModelManager.create(text, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module", params=["all_to_all", "psum"])
def sharded_pair(tmp_path_factory, request):
    root = tmp_path_factory.mktemp("torch_sharded_repo")
    dim = 16
    sizes = [5000, 300]
    tbls = [make_synthetic_table(n, dim, seed=t) for t, n in enumerate(sizes)]
    for t, tbl in enumerate(tbls):
        write_sparse_model(root / f"m_t{t}", tbl.keys, tbl.vectors)
    cfg = {"models": [_model_cfg(root, "m", [dim, dim], {
        "quant_bits": 8, "shard_strategy": request.param,
        "maxnum_catfeature_query_per_table_per_sample": [1, 2],
    })]}
    jm, tm = _managers(cfg)
    yield jm, tm, tbls, sizes, dim
    tm.shutdown()
    jm.shutdown()


def test_sharded_infer_parity(sharded_pair):
    jm, tm, tbls, sizes, dim = sharded_pair
    cache = tm.ps.get_embedding_cache("m", 0)
    assert isinstance(cache, ShardedEmbeddingCache) and cache.mesh.shape["table"] == 8
    assert cache.device.type == "cpu"
    rng = np.random.default_rng(0)
    b = 8
    k0 = tbls[0].keys[rng.integers(0, sizes[0], b)]
    k1 = tbls[1].keys[rng.integers(0, sizes[1], 2 * b)]
    out = _infer_both(jm, tm, "m", np.concatenate([k0, k1]), [b, 2 * b])
    want = np.concatenate([expected_vector(k0, dim).reshape(-1),
                           expected_vector(k1, dim).reshape(-1)])
    assert np.abs(out - want).max() / np.abs(want).max() < 2e-2


def test_sharded_miss_defaults(sharded_pair):
    jm, tm, tbls, sizes, dim = sharded_pair
    b = 4
    k0 = np.full(b, -12345, np.int64)
    k1 = tbls[1].keys[:2 * b]
    out = _infer_both(jm, tm, "m", np.concatenate([k0, k1]), [b, 2 * b])
    assert np.abs(out[: b * dim]).max() == 0.0


def test_sharded_update_then_refresh(sharded_pair):
    """Streamed updates land in the tiers; refresh replaces the sharded
    tables and the new values serve, identically in both packages."""
    jm, tm, tbls, sizes, dim = sharded_pair
    keys = tbls[0].keys[:16]
    new_vecs = np.full((16, dim), 2.5, np.float32)
    ns = []
    for m in (jm, tm):
        m.ps.apply_updates("m", 0, keys, new_vecs)
        ns.append(m.ps.refresh_embedding_cache("m", 0))
    assert ns[0] == ns[1] > 0
    out = _infer_both(jm, tm, "m", np.concatenate([keys[:4], tbls[1].keys[:8]]), [4, 8])
    np.testing.assert_allclose(out[: 4 * dim], 2.5, rtol=2e-2)


def test_sharded_http_frontend(tmp_path):
    """The KServe HTTP surface serves a sharded model unchanged: JSON and
    binary responses byte-identical to the JAX package's."""
    dim = 8
    tbl = make_synthetic_table(2000, dim, seed=9)
    write_sparse_model(tmp_path / "h_t0", tbl.keys, tbl.vectors)
    jm, tm = _managers({"models": [_model_cfg(tmp_path, "h", [dim], {"quant_bits": 32})]})
    servers = []
    try:
        for cls, m in ((JaxHttpServer, jm), (HpsHttpServer, tm)):
            servers.append(cls(m, port=0).start())
        q = np.concatenate([tbl.keys[:13], [-3]])
        bodies = [
            (json.dumps({"inputs": [
                {"name": "KEYS", "datatype": "INT64", "shape": [len(q)],
                 "data": [int(k) for k in q]},
                {"name": "NUMKEYS", "datatype": "INT32", "shape": [1], "data": [len(q)]},
            ]}).encode(), {}),
        ]
        kraw, nraw = q.astype("<i8").tobytes(), np.asarray([len(q)], "<i4").tobytes()
        hdr = json.dumps({"inputs": [
            {"name": "KEYS", "datatype": "INT64", "shape": [len(q)],
             "parameters": {"binary_data_size": len(kraw)}},
            {"name": "NUMKEYS", "datatype": "INT32", "shape": [1],
             "parameters": {"binary_data_size": len(nraw)}}],
            "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}]}).encode()
        bodies.append((hdr + kraw + nraw, {"Inference-Header-Content-Length": str(len(hdr))}))
        resps = []
        for body, headers in bodies:
            got = []
            for s in servers:
                r = urllib.request.Request(f"http://127.0.0.1:{s.port}/v2/models/h/infer",
                                           data=body, method="POST", headers=headers)
                with urllib.request.urlopen(r, timeout=TIMEOUT) as resp:
                    got.append((resp.status, resp.read()))
            assert got[0] == got[1] and got[0][0] == 200
            resps.append(got[1][1])
        out = np.asarray(json.loads(resps[0])["outputs"][0]["data"], np.float32).reshape(-1, dim)
        np.testing.assert_allclose(out[:13], expected_vector(q[:13], dim), rtol=1e-5)
        np.testing.assert_array_equal(out[13], 0.0)
        np.testing.assert_array_equal(np.frombuffer(resps[1][len(resps[1]) - out.nbytes:], "<f4"),
                                      out.reshape(-1))
    finally:
        for s in servers:
            s.stop()
        tm.shutdown()
        jm.shutdown()


def test_sharded_load_unload_reload(tmp_path):
    dim = 8
    tbl = make_synthetic_table(1000, dim, seed=11)
    write_sparse_model(tmp_path / "c_t0", tbl.keys, tbl.vectors)
    jm, tm = _managers({"models": [_model_cfg(tmp_path, "c", [dim],
                                              {"quant_bits": 8, "num_shards": 4})]})
    try:
        for m in (jm, tm):
            assert m.is_loaded("c")
            m.unload("c")
            assert not m.is_loaded("c")
            m.ps.create_embedding_cache_per_model("c")
            m.load("c")
        q = tbl.keys[:6]
        out = _infer_both(jm, tm, "c", q, [6])
        want = expected_vector(q, dim).reshape(-1)
        assert np.abs(out - want).max() / np.abs(want).max() < 2e-2
        # num_shards=4 -> the mesh spans 4 of the 8 listed devices
        cache = tm.ps.get_embedding_cache("c", 0)
        assert cache.mesh.shape["table"] == 4 and len(cache.tables[0].values) == 4
    finally:
        tm.shutdown()
        jm.shutdown()


def test_sharded_int4(tmp_path):
    dim = 8
    tbl = make_synthetic_table(3000, dim, seed=13)
    write_sparse_model(tmp_path / "q_t0", tbl.keys, tbl.vectors)
    jm, tm = _managers({"models": [_model_cfg(tmp_path, "q", [dim], {"quant_bits": 4})]})
    try:
        q = tbl.keys[100:110]
        out = _infer_both(jm, tm, "q", q, [10])
        want = expected_vector(q, dim).reshape(-1)
        assert np.abs(out - want).max() / np.abs(want).max() < 0.15
    finally:
        tm.shutdown()
        jm.shutdown()


def test_sharded_refresh_keeps_tier_dropped_keys(tmp_path):
    """Partial-tier refresh keeps the resident keys the tiers no longer
    hold at their current values."""
    dim = 8
    tbl = make_synthetic_table(600, dim, seed=17)
    write_sparse_model(tmp_path / "k_t0", tbl.keys, tbl.vectors)
    jm, tm = _managers({"models": [_model_cfg(tmp_path, "k", [dim], {"quant_bits": 32})]})
    try:
        keep = tbl.keys[::2]
        new_vecs = np.full((len(keep), dim), 3.25, np.float32)
        ns = []
        for m, tag_of in ((jm, jtable_tag), (tm, table_tag)):
            tag = tag_of("k", m.ps.get_model_params("k").table_name(0))
            m.ps.dram.drop_table(tag)
            m.ps.dram.create_table(tag, dim)
            m.ps.dram.insert(tag, keep, new_vecs)
            ns.append(m.ps.get_embedding_cache("k", 0).refresh())
        assert ns[0] == ns[1] == len(keep)
        q_drop = tbl.keys[1::2][:5]
        out = _infer_both(jm, tm, "k", np.concatenate([keep[:5], q_drop]), [10]).reshape(10, dim)
        np.testing.assert_allclose(out[:5], 3.25, rtol=1e-5)
        np.testing.assert_allclose(out[5:], expected_vector(q_drop, dim), rtol=1e-5)
    finally:
        tm.shutdown()
        jm.shutdown()


def test_sharded_refresh_discovers_streamed_new_keys(tmp_path):
    """Keys streamed into the tiers after the build serve after a refresh:
    refresh is how a sharded table grows."""
    dim = 8
    tbl = make_synthetic_table(400, dim, seed=23)
    write_sparse_model(tmp_path / "g_t0", tbl.keys, tbl.vectors)
    jm, tm = _managers({"models": [_model_cfg(tmp_path, "g", [dim], {"quant_bits": 32})]})
    try:
        new_keys = np.array([10 ** 12 + 7, 10 ** 12 + 9], np.int64)
        new_vecs = np.full((2, dim), 4.5, np.float32)
        for m in (jm, tm):
            m.ps.apply_updates("g", 0, new_keys, new_vecs)
        assert np.abs(_infer_both(jm, tm, "g", new_keys, [2])).max() == 0.0
        for m in (jm, tm):
            m.ps.refresh_embedding_cache("g", 0)
        np.testing.assert_allclose(_infer_both(jm, tm, "g", new_keys, [2]), 4.5, rtol=1e-5)
        q = tbl.keys[:4]
        np.testing.assert_allclose(_infer_both(jm, tm, "g", q, [4]),
                                   expected_vector(q, dim).reshape(-1), rtol=1e-5)
    finally:
        tm.shutdown()
        jm.shutdown()


def test_chip_smoke_sharded_rehearsal(tmp_path, monkeypatch):
    """chip_smoke's sharded phase on the CPU at a small size (4 tables
    capped at 4,096 rows, D 16, batch 64, the process-group mesh on gloo):
    every check of every part runs; no kernel is launched on the CPU."""
    from pathlib import Path

    import torch

    from hugectr_backend_tpu_torch import HierParameterServer

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "device_profile", lambda run, n: (run(), (None, []))[1])
    for name, value in (("DIM", 16), ("TOP", (64, 32, 1)), ("FRONTEND_SAMPLES", 8),
                        ("SHARD_TIMED", 2), ("SHARD_HTTP_REQUESTS", 3)):
        monkeypatch.setattr(cs, name, value)
    cards = [min(c, 4096) for c in cs.CRITEO_CARDS[:4]]
    tables, cfg = cs.build_deployment(str(tmp_path), cards, 16, cs.SEED)
    ps = HierParameterServer.create(cfg, device="cpu")
    try:
        batches = cs.make_batches(tables, 64, 2, cs.SEED + 1)
        lines = []
        res = cs.sharded_phase(torch.device("cpu"), tables, cfg, ps.get_embedding_cache("dlrm", 0),
                               batches, emit_line=lines.append, batch=64)
    finally:
        ps.shutdown()
    assert res["launches"] == {} and res["k1"] is None
    kinds = [(ln["sharded"], ln.get("shards"), ln.get("strategy", ln.get("dense")))
             for ln in lines]
    assert kinds == [
        ("lookup", 2, "psum"), ("lookup", 2, "all_to_all"),
        ("lookup", 8, "psum"), ("lookup", 8, "all_to_all"),
        ("dcn_v2", 2, "psum"), ("dcn_v2", 2, "all_to_all"),
        ("dcn_v2", 0, "unsharded make_dcn_server"),
        ("ps_json_http", 2, "all_to_all"), ("ensemble", 2, "f32"), ("ensemble", 2, "w8a8"),
        ("process_group", None, None)]
    assert lines[0]["rows"] == sum(cards) and lines[0]["keys"] == 64 * 4
    assert lines[-1]["dryrun_multichip_8"]["process_group"]["psum_vs_unsharded_grad"] == 0.0
