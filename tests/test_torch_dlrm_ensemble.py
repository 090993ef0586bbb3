"""MLPerf DLRM behind the port's KServe ensemble, on the CPU: the DLRM dense
format (``io/dense_model.py``, ``hps_tpu_dlrm_v1``), a model repository of
an HPS model, a DLRM and the ensemble chaining them, served by
``serve(model_repository=...)``, held to the plain reference of the
benchmark (``hpsbench/reference/dlrm_ensemble.py``: PyTorch only, f32, z
rounded to bf16 in the interaction as the port's kernels round it).

A small model: 4 tables at D 16 (table 1, of 300 rows, in the one-hot
group that the fused path folds into K3; the other three in one arena that
K1 gathers), bottom 13-32-16, top 26-32-16-1, int8 rows.

Tolerances: the port's logits against the reference's at rtol 1e-5, atol
1e-5 (the two compute the same f32 products in other orders: the fused path
permutes the first top layer's columns for the fold; the CPU's gaps are
below 1e-6 at these widths and 5.2e-6 at MLPerf's, PERF.md); fused against
staged at the same tolerance (the fold's order against K4's).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hpsbench.reference.dlrm_ensemble import DlrmReference
from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.io.dense_model import (
    DlrmDenseModel,
    load_dense_model,
    save_dlrm_model,
)
from hugectr_backend_tpu_torch.io.model_repo import load_repository
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.serving.ensemble import EnsembleServer
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.scheduler import RequestError
from hugectr_backend_tpu_torch.serving.server import serve

ROWS = [5000, 300, 6000, 9000]
DIM = 16
NUM_DENSE = 13
BOTTOM = [NUM_DENSE, 32, DIM]
FEATS = len(ROWS) + 1
TOP = [DIM + FEATS * (FEATS - 1) // 2, 32, 16, 1]
RTOL = ATOL = 1e-5
TIMEOUT = 60
ENS, HPS, DENSE = "dlrm_ens", "hps_dlrm", "dlrm_dense"
STAGE_HISTS = ("hps_ensemble_fused_seconds", "hps_ensemble_fused_translate_seconds",
               "hps_ensemble_fused_assemble_seconds", "hps_ensemble_fused_launch_seconds",
               "hps_ensemble_fused_copy_back_seconds")

HPS_PBTXT = f"""name: "{HPS}"
backend: "hps"
max_batch_size: 1024
input [
  {{ name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] }},
  {{ name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }}
]
output [ {{ name: "OUTPUT0" data_type: TYPE_FP32 dims: [ -1 ] }} ]
instance_group [ {{ count: 1 kind: KIND_GPU gpus: [ 0 ] }} ]
"""
DENSE_PBTXT = f"""name: "{DENSE}"
platform: "hps_tpu_dense"
input [
  {{ name: "dense_in" data_type: TYPE_FP32 dims: [ -1, {NUM_DENSE} ] }},
  {{ name: "emb_in" data_type: TYPE_FP32 dims: [ -1 ] }}
]
output [ {{ name: "logit_out" data_type: TYPE_FP32 dims: [ -1, 1 ] }} ]
"""
ENS_PBTXT = f"""name: "{ENS}"
platform: "ensemble"
input [
  {{ name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] }},
  {{ name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }},
  {{ name: "DENSE" data_type: TYPE_FP32 dims: [ -1, {NUM_DENSE} ] }}
]
output [ {{ name: "LOGITS" data_type: TYPE_FP32 dims: [ -1, 1 ] }} ]
ensemble_scheduling {{ step [
  {{ model_name: "{HPS}" model_version: -1
     input_map {{ key: "KEYS" value: "KEYS" }}
     input_map {{ key: "NUMKEYS" value: "NUMKEYS" }}
     output_map {{ key: "OUTPUT0" value: "EMB" }} }},
  {{ model_name: "{DENSE}" model_version: -1
     input_map {{ key: "dense_in" value: "DENSE" }}
     input_map {{ key: "emb_in" value: "EMB" }}
     output_map {{ key: "logit_out" value: "LOGITS" }} }}
] }}
"""


def _layers(rng, widths):
    return [((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             (rng.normal(size=(b,)) * 0.1).astype(np.float32))
            for a, b in zip(widths, widths[1:])]


def _weights(seed=7):
    rng = np.random.default_rng(seed)
    return _layers(rng, BOTTOM), _layers(rng, TOP)


def _key(t, rows):
    """Table t's key of each row (rows < 0: a key no table holds)."""
    rows = np.asarray(rows, np.int64)
    return np.where(rows < 0, -1 - np.abs(rows), (t + 1) * 1_000_000 + rows)


def _write_tables(vdir, seed):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(n, DIM)).astype(np.float32) for n in ROWS]
    for t, tbl in enumerate(tables):
        write_sparse_model(vdir / f"t{t}.model", _key(t, np.arange(len(tbl))), tbl)
    return tables


def _build_repo(root, cache_type="static", gpucacheper=1.0):
    (root / HPS / "1").mkdir(parents=True)
    (root / HPS / "config.pbtxt").write_text(HPS_PBTXT)
    tables = _write_tables(root / HPS / "1", seed=11)
    (root / DENSE).mkdir()
    (root / DENSE / "config.pbtxt").write_text(DENSE_PBTXT)
    bottom, top = _weights()
    save_dlrm_model(root / DENSE / "1", len(ROWS), bottom, top)
    (root / ENS / "1").mkdir(parents=True)
    (root / ENS / "config.pbtxt").write_text(ENS_PBTXT)
    (root / "ps.json").write_text(json.dumps({"models": [{
        "model": HPS, "sparse_files": [f"t{t}.model" for t in range(len(ROWS))],
        "embedding_vecsize_per_table": [DIM] * len(ROWS),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(ROWS),
        "max_batch_size": 1024, "gpucacheper": gpucacheper,
        "embedding_cache_type": cache_type, "quant_bits": 8,
        "default_value_for_each_table": [0.0] * len(ROWS),
    }]}))
    return tables, (bottom, top)


def _request(b, seed=3, absent=2):
    """-> (rows per table [T][b], dense [b, 13]); ``absent`` keys of table 0
    and 2 that no table holds."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, n, b) for n in ROWS]
    for t in (0, 2):
        rows[t][:absent] = -5
    return rows, np.log1p(rng.integers(0, 1000, (b, NUM_DENSE))).astype(np.float32)


def _inputs(rows, dense):
    keys = np.concatenate([_key(t, r) for t, r in enumerate(rows)])
    return {"KEYS": keys, "NUMKEYS": np.asarray([len(r) for r in rows], np.int32),
            "DENSE": dense}


def _reference(tables, weights, rows, dense):
    return DlrmReference(tables, *weights).logits(dense, rows)


def _serve_bundle(root):
    bundle = load_repository(root, device="cpu")
    mgr = ModelManager.create(bundle.ps_config, load_all=False, device="cpu")
    for name, v in bundle.hps_versions.items():
        mgr.load(name, version=v)
    return bundle, mgr, EnsembleServer(bundle.ensembles[ENS], mgr, bundle.dense)


def _post(port, model, inputs, output):
    raws, entries = [], []
    for name, a in inputs.items():
        dt = {"int64": "INT64", "int32": "INT32", "float32": "FP32"}[a.dtype.name]
        raw = np.ascontiguousarray(a).tobytes()
        entries.append({"name": name, "datatype": dt, "shape": list(a.shape),
                        "parameters": {"binary_data_size": len(raw)}})
        raws.append(raw)
    hdr = json.dumps({"inputs": entries,
                      "outputs": [{"name": output, "parameters": {"binary_data": True}}]}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/{model}/infer",
                                 data=hdr + b"".join(raws),
                                 headers={"Inference-Header-Content-Length": str(len(hdr))})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            body = r.read()
            h = int(r.headers["Inference-Header-Content-Length"])
            return r.status, np.frombuffer(body[h:], "<f4")
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ------------------------------------------------------------------- format


def test_format_round_trips(tmp_path):
    bottom, top = _weights()
    save_dlrm_model(tmp_path / "1", len(ROWS), bottom, top)
    dm = load_dense_model(tmp_path / "1", "m", device="cpu")
    assert isinstance(dm, DlrmDenseModel)
    assert (dm.num_dense, dm.num_tables, dm.dim) == (NUM_DENSE, len(ROWS), DIM)
    assert dm.spec["bottom"] == BOTTOM and dm.spec["top"] == TOP
    state = dm.model.state_dict()
    for mlp, layers in (("bottom", bottom), ("top", top)):
        for i, (w, b) in enumerate(layers):
            np.testing.assert_array_equal(state[f"{mlp}.layers.{i}.weight"].numpy(), w.T)
            np.testing.assert_array_equal(state[f"{mlp}.layers.{i}.bias"].numpy(), b)
    assert dm.model.compute_dtype == torch.float32 and dm.model.quant_fmt is None
    # Saved again from what was loaded, the files hold the same numbers.
    save_dlrm_model(tmp_path / "2", len(ROWS),
                    [(state[f"bottom.layers.{i}.weight"].numpy().T,
                      state[f"bottom.layers.{i}.bias"].numpy()) for i in range(len(bottom))],
                    [(state[f"top.layers.{i}.weight"].numpy().T,
                      state[f"top.layers.{i}.bias"].numpy()) for i in range(len(top))])
    with np.load(tmp_path / "1" / "dense_model.npz") as a, \
            np.load(tmp_path / "2" / "dense_model.npz") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert (json.loads((tmp_path / "1" / "dense_model.json").read_text())
            == json.loads((tmp_path / "2" / "dense_model.json").read_text()))


def _spec_edit(spec, case):
    if case == "bottom_not_dim":
        spec["dim"] = DIM * 2
    elif case == "top_in":
        spec["top"][0] += 1
    elif case == "tables":
        spec["num_tables"] += 1
    elif case == "not_one_logit":
        spec["top"][-1] = 2
    elif case == "quant":
        spec["quant"] = "w8a8"
    elif case == "interaction":
        spec["interaction"] = "cat"
    elif case == "missing":
        del spec["bottom"]


@pytest.mark.parametrize("case", ["bottom_not_dim", "top_in", "tables", "not_one_logit",
                                  "quant", "interaction", "missing", "weights"])
def test_malformed_spec_raises_at_load(tmp_path, case):
    bottom, top = _weights()
    vdir = save_dlrm_model(tmp_path / "1", len(ROWS), bottom, top)
    if case == "weights":
        with np.load(vdir / "dense_model.npz") as z:
            arrays = dict(z)
        arrays["top.1.w"] = arrays["top.1.w"][:, :-1]
        np.savez(vdir / "dense_model.npz", **arrays)
    else:
        spec = json.loads((vdir / "dense_model.json").read_text())
        _spec_edit(spec, case)
        (vdir / "dense_model.json").write_text(json.dumps(spec))
    with pytest.raises(ConfigError):
        load_dense_model(vdir, "m", device="cpu")


def test_save_refuses_a_model_that_is_no_dlrm(tmp_path):
    bottom, top = _weights()
    with pytest.raises(ValueError, match="top\\[0\\]"):
        save_dlrm_model(tmp_path / "1", len(ROWS) + 1, bottom, top)


def test_repository_names_every_input(tmp_path):
    _build_repo(tmp_path)
    dm = load_repository(tmp_path, device="cpu").dense[DENSE]
    assert dm.input_names == ("dense_in", "emb_in") and dm.output_name == "logit_out"
    one = DENSE_PBTXT.replace(
        ',\n  { name: "emb_in" data_type: TYPE_FP32 dims: [ -1 ] }', "")
    assert one != DENSE_PBTXT
    (tmp_path / DENSE / "config.pbtxt").write_text(one)
    with pytest.raises(ConfigError, match="two inputs"):
        load_repository(tmp_path, device="cpu")


# ----------------------------------------------------------------- ensemble


@pytest.mark.parametrize("b", [1, 7, 100])
def test_fused_and_staged_agree_with_the_reference(tmp_path, monkeypatch, b):
    """The fused path engages: one K1 launch that skips the one-hot group
    (table 1, folded into K3), the interaction on K3, only the logits
    copied back. It and the staged path (K4 on OUTPUT0 read as [B, T, D])
    agree with the reference and with each other."""
    tables, weights = _build_repo(tmp_path)
    bundle, mgr, es = _serve_bundle(tmp_path)
    launches, oh = [], []
    real = lookup_program.gather_dequant_groups
    monkeypatch.setattr(lookup_program, "gather_dequant_groups",
                        lambda *a: launches.append(a[4]) or real(*a))
    import hugectr_backend_tpu_torch.models.dlrm as dlrm_mod

    real_oh = dlrm_mod.dot_interaction_oh_parts
    monkeypatch.setattr(dlrm_mod, "dot_interaction_oh_parts",
                        lambda *a, **k: oh.append(a[2].shape) or real_oh(*a, **k))
    try:
        rows, dense = _request(b)
        want = _reference(tables, weights, rows, dense)
        fused = es.infer(_inputs(rows, dense))["LOGITS"]
        assert fused.shape == (b, 1) and fused.dtype == np.float32
        assert len(launches) == 1 and ("skip",) in launches[0]
        assert len(oh) == 1 and oh[0][0] == 1  # one folded table, its slots bucketed
        # the plan's split, the same at every bucket
        assert {es._fused.server.folded_tables(n) for n in (8, 64, 1024)} == {(1,)}
        np.testing.assert_allclose(fused[:, 0], want, rtol=RTOL, atol=ATOL)
        staged = es.infer_staged(_inputs(rows, dense))["LOGITS"]
        assert staged.shape == (b, 1)
        np.testing.assert_allclose(staged[:, 0], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fused, staged, rtol=RTOL, atol=ATOL)
    finally:
        mgr.shutdown()


def test_fused_pads_to_the_bucket_grid(tmp_path, monkeypatch):
    """A request of 100 samples runs the device program at 128, the fused
    DLRM server's bucket; the pad samples read default rows and zero dense
    features, and only the 100 logits come back."""
    _build_repo(tmp_path)
    bundle, mgr, es = _serve_bundle(tmp_path)
    seen = []
    try:
        rows, dense = _request(100)
        es.infer(_inputs(rows, dense))
        server = es._fused.server
        real = server._forward
        monkeypatch.setattr(server, "_forward",
                            lambda *a: seen.append(a[7]) or real(*a))
        out = es.infer(_inputs(rows, dense))["LOGITS"]
        assert seen == [128] and out.shape == (100, 1)
    finally:
        mgr.shutdown()


def test_ragged_malformed_and_oversized_requests(tmp_path):
    tables, weights = _build_repo(tmp_path)
    bundle, mgr, es = _serve_bundle(tmp_path)
    try:
        rows, dense = _request(6)
        es.infer(_inputs(rows, dense))  # builds the fused chain
        ragged = _inputs(rows, dense)
        ragged["KEYS"] = ragged["KEYS"][:-1]
        ragged["NUMKEYS"] = np.asarray([6, 6, 6, 5], np.int32)
        assert es._run_fused(dict(ragged)) is None  # goes staged: the DLRM refuses it
        with pytest.raises(RequestError):
            es.infer(ragged)
        short = _inputs(rows, dense[:5])
        assert es._run_fused(dict(short)) is None
        with pytest.raises(RequestError):
            es.infer(short)
        big_rows, big_dense = _request(1025)
        with pytest.raises(RequestError, match="exceed max batch size"):
            es.infer(_inputs(big_rows, big_dense))
    finally:
        mgr.shutdown()


def test_reload_serves_the_new_tables(tmp_path):
    """A reload replaces the cache; the fused path rebuilds its server over
    the new one and serves the new version's rows."""
    tables, weights = _build_repo(tmp_path)
    bundle, mgr, es = _serve_bundle(tmp_path)
    try:
        rows, dense = _request(9)
        first = es.infer(_inputs(rows, dense))["LOGITS"]
        old_server = es._fused.server
        new_tables = _write_tables(tmp_path / HPS / "2", seed=12)
        mgr.unload(HPS)
        mgr.load(HPS, version=2)
        out = es.infer(_inputs(rows, dense))["LOGITS"]
        assert es._fused.server is not old_server
        np.testing.assert_allclose(out[:, 0], _reference(new_tables, weights, rows, dense),
                                   rtol=RTOL, atol=ATOL)
        assert not np.allclose(out, first)
    finally:
        mgr.shutdown()


def test_partial_cache_serves_staged(tmp_path):
    """A dynamic cache at half the rows: a device miss is not an absent key
    (its row comes from the DRAM tier, in f32), so the chain is not fused."""
    _build_repo(tmp_path, cache_type="dynamic", gpucacheper=0.5)
    bundle, mgr, es = _serve_bundle(tmp_path)
    try:
        rows, dense = _request(5)
        out = es.infer(_inputs(rows, dense))["LOGITS"]
        assert es._fused is None and es._fused_ready
        assert out.shape == (5, 1) and np.isfinite(out).all()
    finally:
        mgr.shutdown()


# --------------------------------------------------------- served over HTTP


def _hists(label):
    out = {}
    for m in metrics.REGISTRY._metrics:
        if isinstance(m, metrics.Histogram) and m.name.startswith("hps_ensemble_fused"):
            out[m.name] = (m.count(model=label), m.sum(model=label))
    return out


def _all_labels():
    return {m.name: m.values() if not isinstance(m, metrics.Histogram) else
            {k: (m.count(**dict(k)), m.sum(**dict(k))) for k in m._total}
            for m in metrics.REGISTRY._metrics if m.name.startswith("hps_ensemble_fused")}


def test_served_over_http_with_spans(tmp_path):
    """Served by ``serve(model_repository=...)``: the ensemble answers the
    reference's logits; each fused request observes the five spans and the
    fused share under the ensemble's label, a staged one only the share (as
    0); a lookup-only request observes none of them; the DLRM model answers
    when called directly by its input names."""
    tables, weights = _build_repo(tmp_path)
    server = serve(model_repository=str(tmp_path), port=0, block=False, device="cpu")
    try:
        rows, dense = _request(40)
        want = _reference(tables, weights, rows, dense)
        before = _hists(ENS)
        status, got = _post(server.port, ENS, _inputs(rows, dense), "LOGITS")
        assert status == 200
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        after = _hists(ENS)
        for name in STAGE_HISTS:
            assert after[name][0] == before[name][0] + 1, name
            assert after[name][1] > before[name][1], name
        share = "hps_ensemble_fused_per_request"
        assert after[share] == (before[share][0] + 1, before[share][1] + 1.0)
        folded = {dict(k)["table"]: v for k, v in metrics.ENSEMBLE_FUSED_FOLDED.values().items()
                  if dict(k)["model"] == ENS}
        assert folded == {"0": 0.0, "1": 1.0, "2": 0.0, "3": 0.0}

        # Ragged (table 3 gets one key fewer): the staged path answers, the DLRM refuses.
        ragged = _inputs(rows, dense)
        ragged["KEYS"] = ragged["KEYS"][:-1]
        ragged["NUMKEYS"] = np.asarray([40, 40, 40, 39], np.int32)
        status, _ = _post(server.port, ENS, ragged, "LOGITS")
        assert status == 400
        # A staged answer: a request the fused path hands on (two keys for a
        # table's sample would be ragged); here the fused chain declined.
        es = server.httpd.RequestHandlerClass.ensembles[ENS]
        before = _hists(ENS)
        fused, es._fused = es._fused, None
        try:
            status, got = _post(server.port, ENS, _inputs(rows, dense), "LOGITS")
        finally:
            es._fused = fused
        assert status == 200
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        after = _hists(ENS)
        assert after[share] == (before[share][0] + 1, before[share][1])
        for name in STAGE_HISTS:
            assert after[name] == before[name], name

        # Lookup-only: none of the ensemble's metrics, under any label.
        before = _all_labels()
        keys = np.concatenate([_key(t, r[:3]) for t, r in enumerate(rows)])
        status, _ = _post(server.port, HPS, {"KEYS": keys,
                                             "NUMKEYS": np.full(4, 3, np.int32)}, "OUTPUT0")
        assert status == 200
        assert _all_labels() == before

        # The DLRM directly, by its input names: OUTPUT0's layout in, logits out.
        emb = DlrmReference(tables, *weights)._emb(rows).transpose(0, 1).reshape(-1)
        status, got = _post(server.port, DENSE, {"dense_in": dense,
                                                 "emb_in": emb.numpy()}, "logit_out")
        assert status == 200
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        status, _ = _post(server.port, DENSE, {"dense_in": dense}, "logit_out")
        assert status == 400
    finally:
        server.stop()
