"""The KServe-v2 HTTP front end: one ps.json served by the JAX package's
``HpsHttpServer`` and by the PyTorch port's (``device="cpu"``), the same
requests sent to both.

Tolerance: none. Responses are compared byte for byte (status, body, and the
binary protocol's header length): both packages quantize the same rows with
the same native quantizer, translate keys to the same slots, dequantize with
one f32 multiply and frame the response the same way.

The deployment: 3 int8 tables of D 16 (one-hot, arena and solo lookup kinds
with the thresholds below), max_batch_size 64, a non-zero default value on
one table. Every socket call has its own timeout, and every server is stopped
in a fixture finalizer.
"""

import dataclasses
import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import make_synthetic_table
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager
from hugectr_backend_tpu.serving.server import HpsHttpServer as JaxHttpServer
from hugectr_backend_tpu_torch.serving import metrics as tmetrics
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.scheduler import ContinuousBatcher, RequestError
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer, serve

DIM = 16
SIZES = [40, 200, 600]
PER_SAMPLE = (1, 2, 1)  # keys of a sample in each table
THRESHOLDS = {"HPS_TPU_ONEHOT_MAX_ROWS": "64", "HPS_TPU_ARENA_MEMBER_MAX_ROWS": "256"}
TIMEOUT = 30


def _config(root, **extra):
    return {"models": [{
        "model": "dlrm",
        "sparse_files": [str(root / f"t{t}") for t in range(len(SIZES))],
        "embedding_vecsize_per_table": [DIM] * len(SIZES),
        "maxnum_catfeature_query_per_table_per_sample": list(PER_SAMPLE),
        "default_value_for_each_table": [0.0, 0.5, 0.0],
        "max_batch_size": 64,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "num_of_worker_buffer_in_pool": 2,
        "max_queue_delay_us": 200,
        "cache_refresh_percentage_per_iteration": 1.0,
        **extra,
    }]}


def _write_tables(root, scale=1.0):
    tbls = [make_synthetic_table(n, DIM, seed=70 + t) for t, n in enumerate(SIZES)]
    for t, tbl in enumerate(tbls):
        write_sparse_model(root / f"t{t}", tbl.keys, tbl.vectors * scale)
    return tbls


@pytest.fixture(scope="module")
def thresholds():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in THRESHOLDS.items():
            mp.setenv(k, v)
        yield


def _start_pair(cfg):
    """-> (JAX server, port server), both on port 0."""
    jsrv = JaxHttpServer(JaxManager.create(cfg), port=0).start()
    try:
        tsrv = HpsHttpServer(ModelManager.create(cfg, device="cpu"), port=0).start()
    except BaseException:
        jsrv.stop()
        raise
    return jsrv, tsrv


@pytest.fixture(scope="module")
def pair(tmp_path_factory, thresholds):
    root = tmp_path_factory.mktemp("torch_frontend")
    tbls = _write_tables(root)
    jsrv, tsrv = _start_pair(_config(root))
    yield jsrv, tsrv, tbls
    tsrv.stop()
    jsrv.stop()


def _call(server, method, path, body=None, headers=None):
    """-> (status, headers, body bytes); HTTP errors are returned, not
    raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                 data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json_request(keys, numkeys):
    return json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [len(keys)],
         "data": [int(k) for k in keys]},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [len(numkeys)],
         "data": [int(n) for n in numkeys]},
    ]}).encode()


def _binary_request(keys, numkeys):
    kraw = np.ascontiguousarray(keys, "<i8").tobytes()
    nraw = np.asarray(numkeys, "<i4").tobytes()
    hdr = json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [len(keys)],
         "parameters": {"binary_data_size": len(kraw)}},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [len(numkeys)],
         "parameters": {"binary_data_size": len(nraw)}}],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}],
    }).encode()
    return hdr + kraw + nraw, {"Inference-Header-Content-Length": str(len(hdr))}


def _request_keys(tbls, rng, samples, per_table=PER_SAMPLE):
    """Flat KEYS (table-major) with ~10 % misses, one a negative key."""
    keys, num = [], []
    for tbl, k in zip(tbls, per_table):
        n = samples * k
        q = tbl.keys[rng.integers(0, tbl.num_rows, n)].copy()
        miss = rng.random(n) < 0.1
        q[miss] = -7 - rng.integers(0, 1 << 40, int(miss.sum()))
        keys.append(q)
        num.append(n)
    return np.concatenate(keys), num


def _dequant(tsrv, keys, num):
    """The port's cache, dequantized on the host in numpy: the expected
    OUTPUT0 of a request."""
    cache = tsrv.manager.ps.get_embedding_cache("dlrm", 0)
    outs, start = [], 0
    for t, n in enumerate(num):
        view = cache.tables[t]
        slots = view.offset + view.index.search(keys[start:start + n]).astype(np.int64)
        start += n
        vals = view.arena.values.numpy()[slots].astype(np.float32)
        outs.append((vals * view.arena.scales.numpy()[slots][:, None]).reshape(-1))
    return np.concatenate(outs)


@pytest.mark.parametrize("samples", [1, 5, 64])
def test_json_infer_identical(pair, samples):
    jsrv, tsrv, tbls = pair
    keys, num = _request_keys(tbls, np.random.default_rng(samples), samples)
    body = _json_request(keys, num)
    got = _call(tsrv, "POST", "/v2/models/dlrm/infer", body)
    want = _call(jsrv, "POST", "/v2/models/dlrm/infer", body)
    assert got[0] == want[0] == 200, got[2]
    assert got[2] == want[2]
    out = np.asarray(json.loads(got[2])["outputs"][0]["data"], np.float32)
    np.testing.assert_array_equal(out, _dequant(tsrv, keys, num))


@pytest.mark.parametrize("samples", [1, 7, 64])
def test_binary_infer_identical(pair, samples):
    jsrv, tsrv, tbls = pair
    keys, num = _request_keys(tbls, np.random.default_rng(100 + samples), samples)
    body, headers = _binary_request(keys, num)
    got = _call(tsrv, "POST", "/v2/models/dlrm/infer", body, headers)
    want = _call(jsrv, "POST", "/v2/models/dlrm/infer", body, headers)
    assert got[0] == want[0] == 200, got[2]
    assert got[2] == want[2]
    hlen = int(got[1]["Inference-Header-Content-Length"])
    assert hlen == int(want[1]["Inference-Header-Content-Length"])
    out = np.frombuffer(got[2][hlen:], "<f4")
    np.testing.assert_array_equal(out, _dequant(tsrv, keys, num))
    # The JSON protocol gives the same floats.
    jout = _call(tsrv, "POST", "/v2/models/dlrm/infer", _json_request(keys, num))
    np.testing.assert_array_equal(
        np.asarray(json.loads(jout[2])["outputs"][0]["data"], np.float32), out)


_BAD = {
    "empty body": (b"", None),
    "not json": (b"\x00\xff\x13garbage", None),
    "truncated json": (b"{", None),
    "missing NUMKEYS": (json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [1], "data": [1]}]}).encode(), None),
    "KEYS as FP64": (json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "FP64", "shape": [1], "data": [1]},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [3], "data": [1, 0, 0]},
    ]}).encode(), None),
    "shape vs data": (json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [2], "data": [1]},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [3], "data": [1, 0, 0]},
    ]}).encode(), None),
    "negative dim": (json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [-3], "data": []},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [3], "data": [0, 0, 0]},
    ]}).encode(), None),
    "NUMKEYS arity": (_json_request([1, 2], [2]), None),
    "NUMKEYS sum": (_json_request([1, 2], [1, 0, 0]), None),
    "negative NUMKEYS": (_json_request([1, 2], [3, -1, 0]), None),
    "too many samples": (_json_request([0] * 65 * 4, [65, 130, 65]), None),
    "bad header length": (b"{}", {"Inference-Header-Content-Length": "x"}),
    "unknown model": (_json_request([1], [1, 0, 0]), "/v2/models/nope/infer"),
    "unknown path": (b"{}", "/v2/nothing/here"),
    "load unknown model": (b"", "/v2/repository/models/nope/load"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_requests_same_status(pair, case):
    jsrv, tsrv, _ = pair
    body, extra = _BAD[case]
    path, headers = "/v2/models/dlrm/infer", None
    if isinstance(extra, dict):
        headers = extra
    elif extra is not None:
        path = extra
    got = _call(tsrv, "POST", path, body, headers)
    want = _call(jsrv, "POST", path, body, headers)
    assert got[0] == want[0] and 400 <= got[0] < 500, (got, want)
    assert json.loads(got[2]) == json.loads(want[2])


@pytest.mark.parametrize("method, path", [
    ("GET", "/v2"), ("GET", "/v2/health/live"), ("GET", "/v2/health/ready"),
    ("GET", "/v2/models/dlrm"), ("GET", "/v2/models/dlrm/ready"),
    ("GET", "/v2/models/dlrm/config"), ("GET", "/v2/models/nope"),
    ("GET", "/v2/models/nope/ready"), ("GET", "/v2/models/nope/stats"),
    ("POST", "/v2/repository/index"),
])
def test_metadata_and_index_identical(pair, method, path):
    jsrv, tsrv, _ = pair
    got = _call(tsrv, method, path, b"" if method == "POST" else None)
    want = _call(jsrv, method, path, b"" if method == "POST" else None)
    assert got[0] == want[0]
    assert json.loads(got[2]) == json.loads(want[2])


def test_metrics_hold_the_batchers_counters(pair):
    _, tsrv, tbls = pair
    keys, num = _request_keys(tbls, np.random.default_rng(5), 3)
    assert _call(tsrv, "POST", "/v2/models/dlrm/infer", _json_request(keys, num))[0] == 200
    status, _, body = _call(tsrv, "GET", "/metrics")
    text = body.decode()
    assert status == 200
    for name in ("hps_inference_request_success", "hps_inference_request_duration_seconds",
                 "hps_inference_batch_size"):
        assert any(line.startswith(name) and 'model="dlrm"' in line
                   for line in text.splitlines()), name
    status, _, body = _call(tsrv, "GET", "/v2/models/dlrm/stats")
    assert status == 200 and json.loads(body)["model_stats"][0]["inference_count"] >= 1


@pytest.fixture
def versioned_pair(tmp_path, thresholds):
    tbls = _write_tables(tmp_path)
    jsrv, tsrv = _start_pair(_config(tmp_path))
    yield jsrv, tsrv, tbls, tmp_path
    tsrv.stop()
    jsrv.stop()


def test_load_unload_with_version_identical(versioned_pair):
    jsrv, tsrv, tbls, root = versioned_pair
    keys, num = _request_keys(tbls, np.random.default_rng(9), 4)
    body = _json_request(keys, num)
    before = _call(tsrv, "POST", "/v2/models/dlrm/infer", body)[2]
    for srv in (jsrv, tsrv):
        assert _call(srv, "POST", "/v2/repository/models/dlrm/unload", b"")[0] == 200
    for path in ("/v2/models/dlrm/ready", "/v2/models/dlrm/infer"):
        got = _call(tsrv, "POST" if path.endswith("infer") else "GET", path, body)
        want = _call(jsrv, "POST" if path.endswith("infer") else "GET", path, body)
        assert got[0] == want[0] == 400 and got[2] == want[2]
    assert (_call(tsrv, "POST", "/v2/repository/index", b"")[2]
            == _call(jsrv, "POST", "/v2/repository/index", b"")[2] == b"[]")
    # Reload: the same bytes again.
    for srv in (jsrv, tsrv):
        assert _call(srv, "POST", "/v2/repository/models/dlrm/load", b"")[0] == 200
    assert _call(tsrv, "POST", "/v2/models/dlrm/infer", body)[2] == before
    # A version bump re-reads the (rewritten) sparse files and refreshes
    # the cache after refresh_delay (0 s).
    _write_tables(root, scale=2.0)
    load2 = json.dumps({"parameters": {"version": "2"}}).encode()
    for srv in (jsrv, tsrv):
        assert _call(srv, "POST", "/v2/repository/models/dlrm/load", load2)[0] == 200
    deadline = time.monotonic() + TIMEOUT
    while True:
        got = _call(tsrv, "POST", "/v2/models/dlrm/infer", body)[2]
        want = _call(jsrv, "POST", "/v2/models/dlrm/infer", body)[2]
        if (got == want and got != before) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert got == want and got != before
    index = _call(tsrv, "POST", "/v2/repository/index", b"")[2]
    assert index == _call(jsrv, "POST", "/v2/repository/index", b"")[2]
    assert json.loads(index) == [{"name": "dlrm", "version": "2", "state": "READY"}]


def test_concurrent_clients_cobatched(pair):
    """Concurrent HTTP clients: each response equals the host dequant of its
    own keys, whatever it was merged with."""
    _, tsrv, tbls = pair
    reqs = [_request_keys(tbls, np.random.default_rng(200 + i), 1 + i % 5) for i in range(16)]
    results = [None] * len(reqs)
    barrier = threading.Barrier(8)

    def client(c):
        barrier.wait(timeout=TIMEOUT)
        for i in range(c, len(reqs), 8):
            body, headers = _binary_request(*reqs[i])
            results[i] = _call(tsrv, "POST", "/v2/models/dlrm/infer", body, headers)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for (keys, num), (status, headers, body) in zip(reqs, results):
        assert status == 200, body
        hlen = int(headers["Inference-Header-Content-Length"])
        np.testing.assert_array_equal(np.frombuffer(body[hlen:], "<f4"),
                                      _dequant(tsrv, keys, num))


def _batcher(tsrv, **over):
    m = tsrv.manager._models["dlrm"]
    params = dataclasses.replace(m.params, **over)
    return ContinuousBatcher(params, m.sessions[0], device_id=0, num_workers=1), m.sessions[0]


def test_batcher_merges_and_regroups(pair):
    """Requests queued within max_queue_delay share one merged lookup; each
    gets exactly its own rows back."""
    _, tsrv, tbls = pair
    batcher, _ = _batcher(tsrv, max_queue_delay_us=300_000)
    try:
        before = tmetrics.BATCH_SIZE.count(model="dlrm")
        reqs = [_request_keys(tbls, np.random.default_rng(300 + i), 2 + i) for i in range(6)]
        futs = [batcher.submit(k, n) for k, n in reqs]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        batches = tmetrics.BATCH_SIZE.count(model="dlrm") - before
        assert 1 <= batches < len(reqs)
        for (keys, num), r in zip(reqs, outs):
            np.testing.assert_array_equal(r.output, _dequant(tsrv, keys, num))
        assert [r.num_samples for r in outs] == [2 + i for i in range(len(reqs))]
    finally:
        batcher.shutdown()


def test_batcher_isolates_a_poisoned_request(pair):
    """A fault while executing a merged batch fails only the request that
    causes it; its peers and later requests are served."""
    _, tsrv, tbls = pair
    batcher, sess = _batcher(tsrv, max_queue_delay_us=300_000)
    poison = np.int64(-987654321)
    real = sess.lookup_flat

    def flaky(merged, **kw):
        if any(poison in np.asarray(m) for m in merged):
            raise RuntimeError("simulated device fault")
        return real(merged, **kw)

    batcher.session = type(sess)(sess.params, sess.cache)
    batcher.session.lookup_flat = flaky
    try:
        good = _request_keys(tbls, np.random.default_rng(41), 2)
        bad_keys = good[0].copy()
        bad_keys[0] = poison
        f_good = batcher.submit(*good)
        f_bad = batcher.submit(bad_keys, good[1])
        np.testing.assert_array_equal(f_good.result(timeout=TIMEOUT).output,
                                      _dequant(tsrv, *good))
        with pytest.raises(RuntimeError, match="simulated device fault"):
            f_bad.result(timeout=TIMEOUT)
        np.testing.assert_array_equal(batcher.infer(*good, timeout=TIMEOUT).output,
                                      _dequant(tsrv, *good))
        with pytest.raises(RequestError, match="NUMKEYS"):
            batcher.submit(good[0], [1, 2])
    finally:
        batcher.shutdown()


def test_serve_entry_point_and_tls(tmp_path, thresholds):
    """``serve`` on the CPU (block=False), plain and over TLS; model
    repositories, ensembles and dense models raise."""
    import ssl
    import subprocess

    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(cert), "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    _write_tables(tmp_path)
    cfg = _config(tmp_path)
    srv = serve(cfg, port=0, block=False, grpc_port=None, tls_certfile=str(cert),
                tls_keyfile=str(key), device="cpu")
    try:
        ctx = ssl.create_default_context(cafile=str(cert))
        with urllib.request.urlopen(f"https://localhost:{srv.port}/v2/health/ready",
                                    context=ctx, timeout=TIMEOUT) as r:
            assert r.status == 200
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v2/health/ready",
                                   timeout=5)
    finally:
        srv.stop()
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        serve(cfg, port=0, block=False, model_repository=str(tmp_path), device="cpu")
    mgr = ModelManager.create(cfg, load_all=False, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="queue A item 6"):
            HpsHttpServer(mgr, port=0, ensembles={"e": object()})
    finally:
        mgr.shutdown()


def test_manager_needs_a_card_unless_asked_for_cpu(tmp_path, thresholds):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    _write_tables(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ModelManager.create(_config(tmp_path))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve(_config(tmp_path), port=0, block=False)


@pytest.mark.parametrize("quant", ["int8", "int4", "fp8", "fp32", "bf16"])
def test_refresh_bit_identical(tmp_path, thresholds, quant):
    """``refresh_embedding_cache`` (what ModelManager runs on a version bump
    and every refresh_interval) re-pulls the resident rows from the DRAM tier:
    after new values land there, both packages serve the same bytes."""
    import hugectr_backend_tpu as jpkg
    import hugectr_backend_tpu_torch as tpkg
    from hugectr_backend_tpu.tiers.base import table_tag

    _write_tables(tmp_path)
    extra = ({"fp8_quant": True} if quant == "fp8" else
             {"quant_bits": {"int8": 8, "int4": 4, "fp32": 32, "bf16": 16}[quant]})
    cfg = _config(tmp_path, **extra)
    jps = jpkg.HierParameterServer.create(cfg)
    tps = tpkg.HierParameterServer.create(cfg, device="cpu")
    rng = np.random.default_rng(17)
    params = tps.get_model_params("dlrm")
    keys = []
    for t, n in enumerate(SIZES):
        tag = table_tag("dlrm", params.table_name(t))
        k = np.sort(tps.dram.keys(tag))[::3]
        v = rng.standard_normal((k.size, DIM)).astype(np.float32) * (t + 1)
        tps.dram.insert(tag, k, v)
        jps.dram.insert(tag, k, v)
        keys.append(np.concatenate([k[:30], [-1]]))
    assert tps.refresh_embedding_cache("dlrm", 0) == jps.refresh_embedding_cache("dlrm", 0) > 0
    got = tps.get_embedding_cache("dlrm", 0).lookup(keys)
    want = jps.get_embedding_cache("dlrm", 0).lookup(keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    tps.shutdown()
    jps.shutdown()
