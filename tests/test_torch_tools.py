"""The port's tools and scripts around the server: ``perf_client`` against
a port server on the CPU, ``frontend_saturation`` and ``auc_parity`` in
smoke mode on the CPU, and the HTTP front end's TCP_NODELAY, which
``frontend_saturation`` showed missing. The converters are held against the
JAX package's tools in tests/test_torch_convert_sparse.py and
tests/test_torch_convert_dense.py.
"""

import http.client
import json
import time
from pathlib import Path

import numpy as np
import pytest

from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------- the servers


def _ps_config(root: Path, n_tables: int = 4, rows: int = 500, dim: int = 16):
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table

    files = []
    for t in range(n_tables):
        tbl = make_synthetic_table(rows, dim, seed=t, key_space=rows)
        write_sparse_model(root / f"t{t}", tbl.keys, tbl.vectors)
        files.append(str(root / f"t{t}"))
    return {"models": [{"model": "dlrm", "sparse_files": files, "max_batch_size": 256,
                        "embedding_vecsize_per_table": [dim] * n_tables,
                        "maxnum_catfeature_query_per_table_per_sample": [1] * n_tables,
                        "gpucacheper": 1.0, "embedding_cache_type": "static"}]}


@pytest.mark.parametrize("protocol", ["http", "http_binary", "grpc"])
def test_perf_client_against_a_port_server(tmp_path, protocol):
    if protocol == "grpc":
        pytest.importorskip("grpc")
    from hugectr_backend_tpu_torch.serving.server import serve
    from hugectr_backend_tpu_torch.tools import perf_client

    server = serve(_ps_config(tmp_path, n_tables=1), port=0, block=False,
                   grpc_port=0 if protocol == "grpc" else None, device="cpu")
    try:
        url = (f"127.0.0.1:{server.grpc.port}" if protocol == "grpc"
               else f"http://127.0.0.1:{server.port}")
        args = ["--url", url, "--model", "dlrm", "--batch", "4", "--keys-per-sample", "1",
                "--key-range", "500", "--concurrency", "2", "--duration", "1"]
        args += {"grpc": ["-i", "grpc"], "http_binary": ["--binary"], "http": []}[protocol]
        out = perf_client.main(args)
    finally:
        server.stop()
    assert out["requests_ok"] > 0 and out["requests_err"] == 0, out
    assert out["qps"] > 0 and out["latency_ms"]["p50"] > 0
    assert set(out) == {"requests_ok", "requests_err", "qps", "samples_per_s", "latency_ms",
                        "concurrency", "batch"}


def test_frontend_saturation_smoke_reports_every_leg(tmp_path, monkeypatch):
    pytest.importorskip("grpc")
    from hugectr_backend_tpu_torch.scripts import frontend_saturation as fs

    monkeypatch.setenv("HPS_SAT_SMOKE", "1")
    out_path = tmp_path / "sat.json"
    assert fs.main(["--device", "cpu", "--out", str(out_path)]) == 0
    out = json.loads(out_path.read_text())
    assert out["server_device"] == "cpu" and "stubbed" in out["device"]
    for leg, _, batch in fs.LEGS:
        r = out[leg]
        assert r["samples_per_s"] > 0 and r["requests_per_s"] > 0, (leg, r)
        assert r["batch_per_request"] == batch and "stubbed" in r["device"]
    assert out["http_b64"]["p50_ms"] > 0


def test_frontend_saturation_stub_keeps_the_device_out(tmp_path):
    """The stub answers every merged batch from a preallocated CPU tensor:
    the session's cache is never asked."""
    from hugectr_backend_tpu_torch.scripts import frontend_saturation as fs

    server, table_keys, n_t = fs.build_server(str(tmp_path), smoke=True, device="cpu")
    try:
        sess = server.manager._models["dlrm"].sessions[0]
        cache = sess.cache
        asked = []
        cache.lookup_flat = lambda *a, **kw: asked.append(a)
        fs.stub_device(server)
        n, wall, _ = fs.run_direct(server, table_keys, n_t, 0.5, 2, 64)
        assert n > 0 and asked == []
        out = sess.lookup_flat([k[:3] for k in table_keys], pad_counts=[4] * n_t)
        assert out.device.type == "cpu" and out.shape == (4 * n_t * fs.DIM,)
    finally:
        server.stop()


def test_small_responses_on_keep_alive_connections_do_not_wait_for_delayed_acks(tmp_path):
    """A response goes out in several writes; with Nagle's algorithm on, the
    last small one waited for the client's delayed ACK (~40 ms on Linux) on
    a keep-alive connection, which held 64-sample requests at a p50 of ~44
    ms against ~3 ms with TCP_NODELAY (``frontend_saturation``'s http_b64
    leg on the CPU)."""
    from hugectr_backend_tpu_torch.serving import server as tserver

    assert tserver._Handler.disable_nagle_algorithm is True
    cfg = _ps_config(tmp_path)
    server = tserver.serve(cfg, port=0, block=False, grpc_port=None, device="cpu")
    try:
        keys = np.concatenate([np.arange(64, dtype=np.int64) + t for t in range(4)])
        kraw, nraw = keys.astype("<i8").tobytes(), np.asarray([64] * 4, "<i4").tobytes()
        hdr = json.dumps({"inputs": [
            {"name": "KEYS", "datatype": "INT64", "shape": [keys.size],
             "parameters": {"binary_data_size": len(kraw)}},
            {"name": "NUMKEYS", "datatype": "INT32", "shape": [4],
             "parameters": {"binary_data_size": len(nraw)}}],
            "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}]}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        lat = []
        for _ in range(25):
            t0 = time.perf_counter()
            conn.request("POST", "/v2/models/dlrm/infer", body=hdr + kraw + nraw, headers={
                "Inference-Header-Content-Length": str(len(hdr))})
            resp = conn.getresponse()
            body = resp.read()
            lat.append(time.perf_counter() - t0)
            assert resp.status == 200 and len(body) > 64 * 4 * 16 * 4
        conn.close()
    finally:
        server.stop()
    assert np.median(lat) < 0.025, sorted(lat)


def test_auc_parity_smoke_on_the_cpu(tmp_path, monkeypatch):
    from hugectr_backend_tpu_torch.scripts import auc_parity

    monkeypatch.setenv("HPS_AUC_SMOKE", "1")
    out_path = tmp_path / "auc.json"
    assert auc_parity.main(["--device", "cpu", "--out", str(out_path)]) == 0
    out = json.loads(out_path.read_text())
    assert out["seeds"] == [0] and out["path_parity"]["seeds"] == [0]
    assert set(out["auc_per_seed"]) == {"fp32", "fp8", "int8", "int4", "int8+dense_int8",
                                       "int8+dense_fp8", "int8+dense_w8a8"}
    assert out["auc_per_seed"]["fp32"][0] > 0.55
    assert all(out["gates"].values()), out["gates"]
    assert out["path_parity"]["oh_kernel_engaged"] == [True]
    assert set(out["path_parity"]["max_abs_delta"]) == {
        "int8_mixed_policy", "int4_mixed_policy", "int8_oh_fold"}
