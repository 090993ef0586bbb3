"""The KServe-v2 gRPC front end: one ps.json served by the JAX package's
``HpsGrpcServer`` and by the PyTorch port's (``device="cpu"``), the same
messages sent to both over a stock grpc channel.

Tolerance: none. Every response is compared as serialized bytes (the
ModelInfer response is framed by hand in ``pb_wire.py``, whose bytes the port
keeps, the unpacked ``shape`` included), every error by its status code and
details. Skipped only where ``grpc`` does not import.
"""

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from hugectr_backend_tpu.io.sparse_model import write_sparse_model  # noqa: E402
from hugectr_backend_tpu.io.synthetic import make_synthetic_table  # noqa: E402
from hugectr_backend_tpu.serving import kserve_pb as jax_kserve_pb  # noqa: E402
from hugectr_backend_tpu.serving.grpc_server import HpsGrpcServer as JaxGrpcServer  # noqa: E402
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager  # noqa: E402
from hugectr_backend_tpu.serving.pb_wire import infer_response_bytes as jax_wire  # noqa: E402
from hugectr_backend_tpu_torch.serving import kserve_pb  # noqa: E402
from hugectr_backend_tpu_torch.serving.grpc_server import HpsGrpcServer  # noqa: E402
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager  # noqa: E402
from hugectr_backend_tpu_torch.serving.pb_wire import infer_response_bytes  # noqa: E402

DIM = 16
SIZES = [40, 200, 600]
THRESHOLDS = {"HPS_TPU_ONEHOT_MAX_ROWS": "64", "HPS_TPU_ARENA_MEMBER_MAX_ROWS": "256"}
TIMEOUT = 30


def _config(root):
    return {"models": [{
        "model": "dlrm",
        "sparse_files": [str(root / f"t{t}") for t in range(len(SIZES))],
        "embedding_vecsize_per_table": [DIM] * len(SIZES),
        "maxnum_catfeature_query_per_table_per_sample": [1, 2, 1],
        "default_value_for_each_table": [0.0, 0.5, 0.0],
        "max_batch_size": 64,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "max_queue_delay_us": 200,
    }]}


class _Client:
    """A stock channel; responses come back as raw bytes."""

    def __init__(self, port, creds=None):
        target = f"localhost:{port}" if creds else f"127.0.0.1:{port}"
        self.channel = (grpc.secure_channel(target, creds) if creds
                        else grpc.insecure_channel(target))

    def call(self, method, request):
        fn = self.channel.unary_unary(
            f"/{kserve_pb.SERVICE_NAME}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=lambda b: b,
        )
        return fn(request, timeout=TIMEOUT)

    def result(self, method, request):
        """-> ("ok", bytes) or (status code, details)."""
        try:
            return "ok", self.call(method, request)
        except grpc.RpcError as e:
            return e.code(), e.details()

    def close(self):
        self.channel.close()


@pytest.fixture(scope="module")
def pb2():
    mod = kserve_pb.load()
    assert jax_kserve_pb.load().ModelInferRequest.DESCRIPTOR.full_name == \
        mod.ModelInferRequest.DESCRIPTOR.full_name
    return mod


def _start(tmp_path, mp):
    for k, v in THRESHOLDS.items():
        mp.setenv(k, v)
    tbls = [make_synthetic_table(n, DIM, seed=80 + t) for t, n in enumerate(SIZES)]
    for t, tbl in enumerate(tbls):
        write_sparse_model(tmp_path / f"t{t}", tbl.keys, tbl.vectors)
    cfg = _config(tmp_path)
    jmgr = JaxManager.create(cfg)
    tmgr = ModelManager.create(cfg, device="cpu")
    return tbls, jmgr, tmgr


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    stack = []
    with pytest.MonkeyPatch.context() as mp:
        tbls, jmgr, tmgr = _start(tmp_path_factory.mktemp("torch_grpc"), mp)
        try:
            jsrv = JaxGrpcServer(jmgr, port=0).start()
            stack.append(lambda: (jsrv.stop(), jmgr.shutdown()))
            tsrv = HpsGrpcServer(tmgr, port=0).start()
            stack.append(lambda: (tsrv.stop(), tmgr.shutdown()))
            jc, tc = _Client(jsrv.port), _Client(tsrv.port)
            stack.append(lambda: (jc.close(), tc.close()))
            yield jc, tc, tbls
        finally:
            for stop in reversed(stack):
                stop()


def _infer_request(pb2, keys, num, raw=True, keys_dt="INT64", num_dt="INT32",
                   model="dlrm"):
    T = pb2.ModelInferRequest.InferInputTensor
    kt = T(name="KEYS", datatype=keys_dt, shape=[len(keys)])
    nt = T(name="NUMKEYS", datatype=num_dt, shape=[len(num)])
    req = pb2.ModelInferRequest(model_name=model, id="req-1", inputs=[kt, nt])
    kwire = {"INT64": "<i8", "FP32": "<f4"}[keys_dt]
    nwire = {"INT32": "<i4", "INT64": "<i8"}[num_dt]
    if raw:
        req.raw_input_contents.extend([np.asarray(keys, kwire).tobytes(),
                                       np.asarray(num, nwire).tobytes()])
    else:
        kt_field = {"INT64": "int64_contents", "FP32": "fp32_contents"}[keys_dt]
        getattr(req.inputs[0].contents, kt_field).extend(
            np.asarray(keys, kwire).tolist())
        nt_field = {"INT32": "int_contents", "INT64": "int64_contents"}[num_dt]
        getattr(req.inputs[1].contents, nt_field).extend(np.asarray(num, nwire).tolist())
    return req


def _keys(tbls, rng, samples):
    keys, num = [], []
    for tbl, k in zip(tbls, (1, 2, 1)):
        n = samples * k
        q = tbl.keys[rng.integers(0, tbl.num_rows, n)].copy()
        miss = rng.random(n) < 0.1
        q[miss] = -7 - rng.integers(0, 1 << 40, int(miss.sum()))
        keys.append(q)
        num.append(n)
    return np.concatenate(keys), num


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("samples", [1, 9, 64])
def test_model_infer_bytes_identical(pair, pb2, samples, raw):
    jc, tc, tbls = pair
    keys, num = _keys(tbls, np.random.default_rng(samples), samples)
    req = _infer_request(pb2, keys, num, raw=raw)
    got, want = tc.call("ModelInfer", req), jc.call("ModelInfer", req)
    assert got == want
    msg = pb2.ModelInferResponse.FromString(got)
    assert msg.parameters["NumSample"].int64_param == samples
    assert np.frombuffer(msg.raw_output_contents[0], "<f4").size == len(keys) * DIM


@pytest.mark.parametrize("case", [
    "unknown model", "missing NUMKEYS", "KEYS as FP32", "NUMKEYS as INT64",
    "raw count", "too many samples", "NUMKEYS arity", "ragged raw bytes",
])
def test_errors_identical(pair, pb2, case):
    jc, tc, tbls = pair
    keys, num = _keys(tbls, np.random.default_rng(3), 2)
    req = _infer_request(pb2, keys, num)
    if case == "unknown model":
        req.model_name = "nope"
    elif case == "missing NUMKEYS":
        del req.inputs[1]
        del req.raw_input_contents[1]
    elif case == "KEYS as FP32":
        req = _infer_request(pb2, keys, num, keys_dt="FP32")
    elif case == "NUMKEYS as INT64":
        req = _infer_request(pb2, keys, num, num_dt="INT64")
    elif case == "raw count":
        del req.raw_input_contents[1]
    elif case == "too many samples":
        req = _infer_request(pb2, np.zeros(65 * 4, np.int64), [65, 130, 65])
    elif case == "NUMKEYS arity":
        req = _infer_request(pb2, keys, [len(keys)])
    elif case == "ragged raw bytes":
        req.raw_input_contents[0] = req.raw_input_contents[0][:-3]
    got, want = tc.result("ModelInfer", req), jc.result("ModelInfer", req)
    assert got == want and got[0] != "ok"


@pytest.mark.parametrize("method, req", [
    ("ServerLive", "ServerLiveRequest"), ("ServerReady", "ServerReadyRequest"),
    ("ServerMetadata", "ServerMetadataRequest"),
    ("ModelReady", ("ModelReadyRequest", "dlrm")),
    ("ModelReady", ("ModelReadyRequest", "nope")),
    ("ModelMetadata", ("ModelMetadataRequest", "dlrm")),
    ("ModelMetadata", ("ModelMetadataRequest", "nope")),
    ("RepositoryIndex", "RepositoryIndexRequest"),
])
def test_health_metadata_index_identical(pair, pb2, method, req):
    jc, tc, _ = pair
    if isinstance(req, tuple):
        msg = getattr(pb2, req[0])(name=req[1])
    else:
        msg = getattr(pb2, req)()
    assert tc.result(method, msg) == jc.result(method, msg)


def test_load_unload_with_version_identical(tmp_path, pb2):
    with pytest.MonkeyPatch.context() as mp:
        tbls, jmgr, tmgr = _start(tmp_path, mp)
        servers = [JaxGrpcServer(jmgr, port=0).start(), HpsGrpcServer(tmgr, port=0).start()]
        clients = [_Client(s.port) for s in servers]
        try:
            keys, num = _keys(tbls, np.random.default_rng(11), 3)
            req = _infer_request(pb2, keys, num)
            before = [c.call("ModelInfer", req) for c in clients]
            assert before[0] == before[1]
            for c in clients:
                c.call("RepositoryModelUnload",
                       pb2.RepositoryModelUnloadRequest(model_name="dlrm"))
            for method, msg in (
                    ("RepositoryIndex", pb2.RepositoryIndexRequest()),
                    ("ModelReady", pb2.ModelReadyRequest(name="dlrm")),
                    ("ModelInfer", req),
                    ("RepositoryModelLoad",
                     pb2.RepositoryModelLoadRequest(model_name="nope"))):
                got, want = clients[1].result(method, msg), clients[0].result(method, msg)
                assert got == want, method
            load = pb2.RepositoryModelLoadRequest(
                model_name="dlrm", parameters={"version": pb2.InferParameter(int64_param=2)})
            for c in clients:
                c.call("RepositoryModelLoad", load)
            index = [c.call("RepositoryIndex", pb2.RepositoryIndexRequest()) for c in clients]
            assert index[0] == index[1]
            m = pb2.RepositoryIndexResponse.FromString(index[1]).models[0]
            assert (m.name, m.version, m.state) == ("dlrm", "2", "READY")
            assert [c.call("ModelInfer", req) for c in clients] == before
        finally:
            for c in clients:
                c.close()
            for s in servers:
                s.stop()
            jmgr.shutdown()
            tmgr.shutdown()


def test_descriptor_is_the_protos_compile(pb2):
    """The committed descriptor is protoc's compile of kserve_v2.proto, byte
    for byte the one the JAX package's generated module registers."""
    import re
    import shutil

    if shutil.which("protoc") is None:
        pytest.skip("protoc is not installed")
    data = kserve_pb.DESCRIPTOR_FILE.read_bytes()
    assert kserve_pb.compile_descriptor() == data
    assert jax_kserve_pb.load().DESCRIPTOR.serialized_pb == data
    assert pb2.DESCRIPTOR.serialized_pb == data
    assert re.search(rb"package inference;", kserve_pb.PROTO.read_bytes())


def test_pb_wire_matches_generated_serializer_and_the_jax_bytes(pb2):
    """The hand-framed response parses back to the message the generated
    code builds, and its bytes are the JAX package's."""
    out = np.arange(37, dtype="<f4")
    args = ("dlrm", "3", "req-9", {"NumSample": 5, "DeviceID": 0}, "OUTPUT0", "FP32", [37])
    wire = infer_response_bytes(*args, out)
    assert wire == jax_wire(*args, out)
    ref = pb2.ModelInferResponse(
        model_name="dlrm", model_version="3", id="req-9",
        parameters={"NumSample": pb2.InferParameter(int64_param=5),
                    "DeviceID": pb2.InferParameter(int64_param=0)},
        outputs=[pb2.ModelInferResponse.InferOutputTensor(
            name="OUTPUT0", datatype="FP32", shape=[37])],
        raw_output_contents=[out.tobytes()],
    )
    assert pb2.ModelInferResponse.FromString(wire) == ref
    # The generated serializer packs the repeated shape; pb_wire writes it
    # unpacked, as the JAX package does (ROADMAP queue C).
    assert wire != ref.SerializeToString()


def test_tls_and_the_ensemble_refusal(tmp_path, pb2):
    import shutil
    import subprocess

    from hugectr_backend_tpu_torch.serving.server import serve

    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(cert), "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in THRESHOLDS.items():
            mp.setenv(k, v)
        for t, n in enumerate(SIZES):
            tbl = make_synthetic_table(n, DIM, seed=80 + t)
            write_sparse_model(tmp_path / f"t{t}", tbl.keys, tbl.vectors)
        srv = serve(_config(tmp_path), port=0, grpc_port=0, block=False,
                    tls_certfile=str(cert), tls_keyfile=str(key), device="cpu")
    try:
        client = _Client(srv.grpc.port, grpc.ssl_channel_credentials(cert.read_bytes()))
        try:
            ready = pb2.ServerReadyResponse.FromString(
                client.call("ServerReady", pb2.ServerReadyRequest()))
            assert ready.ready
        finally:
            client.close()
        # Ensembles and dense models are served now (tests/test_torch_ensemble.py);
        # an empty set of each leaves the index to the HPS models.
        extra = HpsGrpcServer(srv.manager, port=0, ensembles={}, dense_models={}).start()
        try:
            client = _Client(extra.port)
            try:
                index = pb2.RepositoryIndexResponse.FromString(
                    client.call("RepositoryIndex", pb2.RepositoryIndexRequest()))
                assert [m.name for m in index.models] == ["dlrm"]
            finally:
                client.close()
        finally:
            extra.stop()
    finally:
        srv.stop()
