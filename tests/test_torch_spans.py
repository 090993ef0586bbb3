"""The spans of the serving path (utils/tracing.py): a tiny HPS model behind
the port's HTTP server on the CPU, called by several client threads at once.

Held here: every stage histogram counts once per request or per merged
batch, and only for batches that answer; the launches per batch are what
the batcher thread's launch tally counted; the five dispatch stages fit
inside the dispatch; under ``start_trace`` the Chrome trace holds the handler's and
the batcher's ranges (the batcher's workers ran before the profiler
started), and the span log ties each request's read, queue, wait and write
to one request id and one merged batch; ``HPS_TPU_DISABLE_TRACING`` takes the ranges and the
log away and leaves the histograms.
"""

import glob
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.ops import dequant_gather, kernels
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer
from hugectr_backend_tpu_torch.utils import tracing
from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

MODEL = "spans_dlrm"
DIM = 8
SIZES = [50, 300]
PER_SAMPLE = (1, 2)
CLIENTS = 4
REQUESTS = 6  # per client
SAMPLES = 8   # per request
TIMEOUT = 30

STAGES = {  # histogram -> how often it counts: per request or per merged batch
    "hps_http_read_seconds": "request",
    "hps_http_write_seconds": "request",
    "hps_inference_queue_duration_seconds": "request",
    "hps_dispatch_lock_wait_seconds": "batch",
    "hps_dispatch_translate_seconds": "batch",
    "hps_dispatch_assemble_seconds": "batch",
    "hps_dispatch_launch_seconds": "batch",
    "hps_dispatch_copy_back_seconds": "batch",
    "hps_k1_launches_per_batch": "batch",
}
DISPATCH_STAGES = [k for k in STAGES if k.startswith("hps_dispatch_")]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_spans")
    tables = [make_synthetic_table(n, DIM, seed=90 + t) for t, n in enumerate(SIZES)]
    for t, tbl in enumerate(tables):
        write_sparse_model(root / f"t{t}", tbl.keys, tbl.vectors)
    cfg = {"models": [{
        "model": MODEL,
        "sparse_files": [str(root / f"t{t}") for t in range(len(SIZES))],
        "embedding_vecsize_per_table": [DIM] * len(SIZES),
        "maxnum_catfeature_query_per_table_per_sample": list(PER_SAMPLE),
        "max_batch_size": 64,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "num_of_worker_buffer_in_pool": 2,
        "max_queue_delay_us": 2000,
    }]}
    srv = HpsHttpServer(ModelManager.create(cfg, device="cpu"), port=0).start()
    yield srv, tables
    srv.stop()


def _body(tables, rng):
    keys = np.concatenate([tbl.keys[rng.integers(0, tbl.num_rows, SAMPLES * k)]
                           for tbl, k in zip(tables, PER_SAMPLE)])
    kraw = np.ascontiguousarray(keys, "<i8").tobytes()
    nraw = np.asarray([SAMPLES * k for k in PER_SAMPLE], "<i4").tobytes()
    hdr = json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [len(keys)],
         "parameters": {"binary_data_size": len(kraw)}},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [len(PER_SAMPLE)],
         "parameters": {"binary_data_size": len(nraw)}}],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}],
    }).encode()
    return hdr + kraw + nraw, len(hdr)


def _load(server):
    """CLIENTS threads, each sending REQUESTS on one keep-alive connection.
    -> the statuses."""
    srv, tables = server
    statuses, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
        try:
            for _ in range(REQUESTS):
                body, hdr_len = _body(tables, rng)
                conn.request("POST", f"/v2/models/{MODEL}/infer", body=body,
                             headers={"Inference-Header-Content-Length": str(hdr_len)})
                r = conn.getresponse()
                r.read()
                with lock:
                    statuses.append(r.status)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(s,)) for s in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return statuses


def _snapshot():
    return {h.name: (h.count(model=MODEL), h.sum(model=MODEL))
            for h in metrics.REGISTRY._metrics if isinstance(h, metrics.Histogram)}


def _served(server):
    """Send the load; -> (histograms' (count, sum) over it, merged batches).
    A handler observes its write once the answer has left, and a batcher its
    batch's size once the answers are set: both are waited for."""
    before = _snapshot()
    statuses = _load(server)
    assert statuses == [200] * CLIENTS * REQUESTS
    deadline = time.monotonic() + TIMEOUT
    while True:
        after = _snapshot()
        delta = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
                 for k in after}
        if (delta["hps_http_write_seconds"][0] == CLIENTS * REQUESTS
                and delta["hps_inference_batch_size"][1] == CLIENTS * REQUESTS * SAMPLES
                or time.monotonic() > deadline):
            return delta, delta["hps_batch_dispatch_seconds"][0]
        time.sleep(0.01)


def _batcher_tids(server):
    return {w.native_id for b in server[0].manager._models[MODEL].batchers.values()
            for w in b._workers}


def test_stage_histograms_count_each_request_and_batch(one_torch_thread, server,
                                                       monkeypatch):
    # The CPU path launches nothing and counts nothing. Here it counts two
    # launches a call on the calling thread's tally, as a launch would: the
    # batcher observes each batch's delta, whatever it is.
    plain = dequant_gather.gather_dequant_groups_ref

    def counted(*args):
        kernels.count_launch("gather_dequant")
        kernels.count_launch("gather_dequant")
        return plain(*args)

    monkeypatch.setattr(dequant_gather, "gather_dequant_groups_ref", counted)
    launched = kernels.launches["gather_dequant"]
    delta, batches = _served(server)
    assert 1 <= batches <= CLIENTS * REQUESTS
    assert delta["hps_inference_batch_size"][1] == CLIENTS * REQUESTS * SAMPLES
    per = {"request": CLIENTS * REQUESTS, "batch": batches}
    for name, unit in STAGES.items():
        assert delta[name][0] == per[unit], name
    count, total = delta["hps_k1_launches_per_batch"]
    assert total == kernels.launches["gather_dequant"] - launched == 2 * count


def test_dispatch_stages_fit_inside_the_dispatch(one_torch_thread, server):
    delta, _ = _served(server)
    stages = sum(delta[k][1] for k in DISPATCH_STAGES)
    assert 0 < stages <= delta["hps_batch_dispatch_seconds"][1]


def _trace(server, tmp_path):
    """The load under start_trace / stop_trace. -> (Chrome trace events,
    span log events or None, histograms' delta)."""
    tracing.start_trace(str(tmp_path))
    try:
        delta, _ = _served(server)
        # Each handler logs its request's span once the answer has left.
        deadline = time.monotonic() + TIMEOUT
        while (tracing._log is not None and time.monotonic() < deadline
               and sum(e[0] == "hps.http.request" for e in list(tracing._log.entries))
               < CLIENTS * REQUESTS):
            time.sleep(0.01)
    finally:
        path = tracing.stop_trace()
    with open(path) as f:
        chrome = json.load(f)["traceEvents"]
    spans = glob.glob(str(tmp_path / "hps_spans_*.json"))
    log = None
    if spans:
        (spans,) = spans
        assert os.path.basename(spans) == os.path.basename(path).replace("hps_trace_",
                                                                         "hps_spans_")
        with open(spans) as f:
            log = json.load(f)
    return chrome, log, delta


def test_trace_holds_the_handler_and_batcher_ranges(one_torch_thread, server, tmp_path,
                                                    monkeypatch):
    monkeypatch.delenv("HPS_TPU_DISABLE_TRACING", raising=False)
    chrome, log, _ = _trace(server, tmp_path)
    ranges = [e for e in chrome if e.get("ph") == "X" and e["name"].startswith("hps.")]
    tids = {}
    for e in ranges:
        tids.setdefault(e["name"], set()).add(e["tid"])
    batcher = _batcher_tids(server)
    # The batcher's workers ran before the profiler started.
    assert tids["hps.dispatch.copy_back"] and tids["hps.dispatch.copy_back"] <= batcher
    assert tids["hps.http.write"] and not tids["hps.http.write"] & batcher
    assert threading.get_native_id() not in tids["hps.http.write"]
    # The log's clock is the trace's: each logged batch lies on a range of
    # its name and thread.
    by_key = {}
    for e in ranges:
        by_key.setdefault((e["name"], e["tid"]), []).append(e)
    gaps = []
    for e in log["traceEvents"]:
        if e["ph"] == "X" and e["name"] == "hps.batch":
            near = min(by_key[("hps.batch", e["tid"])], key=lambda r: abs(r["ts"] - e["ts"]))
            gaps.append(abs(near["ts"] - e["ts"]))
    assert gaps and np.median(gaps) < 500.0  # µs
    assert log["otherData"]["dropped_spans"] == 0


def test_span_log_ties_each_request_to_one_batch(one_torch_thread, server, tmp_path,
                                                 monkeypatch):
    monkeypatch.delenv("HPS_TPU_DISABLE_TRACING", raising=False)
    _, log, _ = _trace(server, tmp_path)
    events = log["traceEvents"]
    by_request, batches = {}, []
    for e in events:
        a = e["args"]
        if e["name"] == "hps.batch":
            batches.append(a)
        elif "request" in a and e["ph"] in ("X", "b"):
            by_request.setdefault(a["request"], set()).add(e["name"])
    answered = [r for r, names in by_request.items() if "hps.http.request" in names]
    assert len(answered) == CLIENTS * REQUESTS
    for r in answered:
        assert by_request[r] == {"hps.http.request", "hps.http.read", "hps.queue",
                                 "hps.http.wait", "hps.http.write"}, r
        assert sum(r in b["requests"] for b in batches) == 1, r
    # Each stage sits under its parent, on its parent's thread and inside it.
    seq = {e["args"]["seq"]: e for e in events if e["ph"] == "X"}
    parents = {"hps.http.read": "hps.http.request", "hps.http.write": "hps.http.request",
               "hps.batch.merge": "hps.batch", "hps.dispatch": "hps.batch",
               "hps.batch.split": "hps.batch", "hps.dispatch.lock_wait": "hps.dispatch",
               "hps.dispatch.translate": "hps.dispatch",
               "hps.dispatch.assemble": "hps.dispatch",
               "hps.dispatch.launch": "hps.dispatch",
               "hps.dispatch.copy_back": "hps.dispatch"}
    for e in seq.values():
        if e["name"] in parents:
            p = seq[e["args"]["parent_seq"]]
            assert p["name"] == parents[e["name"]] == e["args"]["parent"]
            assert p["tid"] == e["tid"]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
            if p["name"] == "hps.batch":
                assert e["args"]["batch"] == p["args"]["batch"]


def test_switch_takes_ranges_and_log_not_histograms(one_torch_thread, server, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("HPS_TPU_DISABLE_TRACING", "1")
    chrome, log, delta = _trace(server, tmp_path)
    assert log is None
    assert not [e for e in chrome if str(e.get("name", "")).startswith("hps.")]
    assert delta["hps_http_write_seconds"][0] == CLIENTS * REQUESTS
    assert delta["hps_dispatch_copy_back_seconds"][0] >= 1


def test_span_without_a_profiler_opens_no_range(monkeypatch):
    import torch.profiler

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    h = metrics.Histogram("hps_test_span_seconds", "test")
    with tracing.span("hps.test", h, "m", request=7) as s:
        assert tracing.current_request() == 7
    assert tracing.current_request() is None
    assert h.count(model="m") == 1 and h.sum(model="m") == (s.t1 - s.t0) * 1e-9
    with pytest.raises(ValueError), tracing.span("hps.test", h, "m"):
        raise ValueError
    assert h.count(model="m") == 1  # a block that raised is not observed


def test_held_observes_only_when_the_block_answers():
    h = metrics.Histogram("hps_test_held_seconds", "test")
    with pytest.raises(ValueError), tracing.held():
        with tracing.span("hps.test.a", h, "m"):
            pass
        assert h.count(model="m") == 0  # held back
        raise ValueError  # e.g. a later stage of the batch fails
    assert h.count(model="m") == 0
    with tracing.held():
        for name in ("hps.test.a", "hps.test.b"):
            with tracing.span(name, h, "m"):
                pass
        assert h.count(model="m") == 0
    assert h.count(model="m") == 2
    with tracing.span("hps.test.c", h, "m"):
        pass
    assert h.count(model="m") == 3  # outside held: at once


def test_span_log_counts_what_it_drops(monkeypatch, tmp_path):
    monkeypatch.delenv("HPS_TPU_DISABLE_TRACING", raising=False)
    monkeypatch.setattr(tracing, "LOG_CAP", 3)
    tracing.start_trace(str(tmp_path))
    try:
        with tracing.span("hps.outer", batch=1):
            for _ in range(4):
                with tracing.annotate("hps.inner"):
                    pass
        tracing.log_interval("hps.queue", 1.0, 2.0, request=5)
    finally:
        tracing.stop_trace()
    (path,) = glob.glob(str(tmp_path / "hps_spans_*.json"))
    with open(path) as f:
        log = json.load(f)
    names = [e["name"] for e in log["traceEvents"]]
    assert names == ["hps.inner"] * 3
    assert log["otherData"]["dropped_spans"] == 3
    assert all(e["args"]["batch"] == 1 and e["args"]["parent"] == "hps.outer"
               for e in log["traceEvents"])


def test_idle_split_by_batcher_stage():
    from hugectr_backend_tpu_torch.scripts.span_idle import NO_BATCH, OTHER_BATCH, breakdown

    def x(name, ts, end, tid=0, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}

    # The device busy in [0, 10], [30, 40] and [90, 100] of a [0, 100] µs window.
    events = [x("kernel", 0, 10, cat="kernel"), x("Memcpy DtoH", 30, 40, cat="gpu_memcpy"),
              x("kernel", 90, 95, cat="kernel"), x("Memcpy DtoH", 95, 100, cat="gpu_memcpy"),
              # batcher 1: a batch in [5, 88], its copy back and its merge
              x("hps.batch", 5, 88, 1), x("hps.dispatch.copy_back", 20, 45, 1),
              x("hps.batch.merge", 50, 60, 1),
              # batcher 2: a batch in [70, 85], translating throughout
              x("hps.batch", 70, 85, 2), x("hps.dispatch.translate", 70, 85, 2),
              # a handler: not a batcher thread
              x("hps.http.write", 60, 80, 3), x("hps.dispatch.launch", 60, 80, 3),
              # the device's row: not a host range
              x("hps.dispatch.copy_back", 90, 100, 7, cat="gpu_user_annotation")]
    out = breakdown(events)
    assert out["batcher_threads"] == 2 and out["skew_us"] == 0.0
    assert (out["window_ms"], out["busy_ms"], out["idle_ms"]) == (0.1, 0.03, 0.07)
    split = {k: round(v * 1e3, 9) for k, v in out["idle_by_stage_ms"].items() if v}
    # idle [10, 30] and [40, 90]. Batcher 1: copy back [20, 30] and [40, 45],
    # merge [50, 60], between stages [10, 20], [45, 50] and [60, 88], out of
    # a batch [88, 90]. Batcher 2: translation [70, 85], out of a batch the
    # other 55, of it 53 in batcher 1's batch. No batch at all: [88, 90].
    assert split == {"hps.dispatch.copy_back": 7.5, "hps.dispatch.translate": 7.5,
                     "hps.batch.merge": 5, "hps.batch": 21.5, OTHER_BATCH: 26.5, NO_BATCH: 2}
    assert round(sum(split.values()), 9) == 70
    assert out["dtoh_in_copy_back"] == {"count": 0.5, "device_time": 10 / 15, "copies": 2}


def test_device_ops_move_back_by_the_skew_the_trace_shows():
    from hugectr_backend_tpu_torch.scripts.span_idle import breakdown

    # The copy's runtime call is stamped 2 µs after the copy starts on the
    # device, which causality forbids: the device's clock runs 2 µs ahead,
    # and the copy, moved back, lies inside its copy back.
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 10,
               "dur": 6, "tid": 1, "args": {"correlation": 5}},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 8, "dur": 4,
               "tid": 7, "args": {"correlation": 5}},
              {"ph": "X", "cat": "user_annotation", "name": "hps.dispatch.copy_back",
               "ts": 10, "dur": 10, "tid": 1}]
    out = breakdown(events)
    assert out["skew_us"] == 2
    assert out["dtoh_in_copy_back"]["count"] == 1.0
