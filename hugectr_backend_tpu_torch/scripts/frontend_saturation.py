"""The serving front end's software alone, with the DEVICE STUBBED OUT.

Port of the JAX package's ``scripts/frontend_saturation.py``. The server is
booted as usual (on the card unless ``--device cpu``), then every session's
``lookup_flat`` is replaced, inside this script only, by a stub that returns
a preallocated CPU tensor of the right size: no lookup reaches the device, so
every measured microsecond is front-end software (validate + merge + pad +
response split + the HTTP / gRPC codec). Set beside the front end's numbers
with the device in the loop (``chip_smoke.py``'s ``frontend`` phase), it
splits a request's latency into software and device.

Legs, each reporting requests/s, samples/s, merged batches/s (256-sample
equivalents) and the batcher's software time per batch:
- direct:  threads submit straight into the ContinuousBatcher (no codec),
           64-sample requests merged up to 256 and 256-sample requests;
- http:    KServe binary-tensor clients on keep-alive connections, with
           the client's p50 / p99; 256-sample requests as in the JAX script,
           and 64-sample ones, the shape of chip_smoke's frontend traffic;
- grpc:    ModelInfer clients (pre-serialized requests).
The clients are threads of this process and share its cores with the server.

Configuration (the JAX script's): the 26 Criteo-Kaggle cardinalities capped
at 20,000 rows, D 48 (random rows), one key a table per sample,
max_batch_size 256; concurrency min(8, 2 x cores) (and 2), 6 s a leg.
``HPS_SAT_SMOKE=1`` (the JAX script's switch) for the quick pass: 4 tables
of at most 2,000 rows, concurrency 2, 2 s a leg.

    [HPS_SAT_SMOKE=1] python -m hugectr_backend_tpu_torch.scripts.frontend_saturation \\
        [--device cpu] [--out frontend_saturation.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.serving.server import serve

# Criteo-Kaggle cardinalities (capped), as in the JAX package's bench.py.
CRITEO_CARDS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
]
DIM = 48
STUBBED = "stubbed (preallocated CPU outputs): front-end software only, no device"


def build_server(root: str, smoke: bool, device=None):
    cards = [min(c, 2_000 if smoke else 20_000) for c in CRITEO_CARDS]
    if smoke:
        cards = cards[:4]
    sparse_files, table_keys = [], []
    for i, c in enumerate(cards):
        tbl = make_synthetic_table(c, DIM, seed=i, deterministic_fn=False)
        p = f"{root}/t{i}"
        write_sparse_model(p, tbl.keys, tbl.vectors)
        sparse_files.append(p)
        table_keys.append(tbl.keys)
    cfg = {
        "supportlonglong": True,
        "models": [{
            "model": "dlrm", "sparse_files": sparse_files,
            "max_batch_size": 256,
            "embedding_vecsize_per_table": [DIM] * len(cards),
            "maxnum_catfeature_query_per_table_per_sample": [1] * len(cards),
            "default_value_for_each_table": [0.0] * len(cards),
            "deployed_device_list": [0], "gpucache": True,
            "gpucacheper": 1.0,
        }],
    }
    server = serve(ps_source=cfg, port=0, block=False, grpc_port=0, device=device)
    return server, table_keys, len(cards)


def stub_device(server) -> None:
    """Replace every session's ``lookup_flat`` with a stub that returns a
    preallocated CPU tensor (one per padded shape): the batcher's
    ``.cpu().numpy()`` then touches no device, and what remains is front-end
    software. Only this script installs it."""
    m = server.manager._models["dlrm"]
    outs: dict[tuple, torch.Tensor] = {}

    def make_stub(sess):
        dims = [t.dim for t in sess.cache.tables]

        def stub(merged, pad_counts=None, **kw):
            counts = pad_counts or [k.shape[0] for k in merged]
            key = tuple(counts)
            out = outs.get(key)
            if out is None:
                out = torch.zeros(sum(c * d for c, d in zip(counts, dims)),
                                  dtype=torch.float32)
                outs[key] = out
            return out

        return stub

    for sess in m.sessions.values():
        sess.lookup_flat = make_stub(sess)


def _run_threads(client, conc: int, duration: float) -> float:
    stop = threading.Event()
    threads = [threading.Thread(target=client, args=(c, stop), daemon=True)
               for c in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    return time.perf_counter() - t0


def run_direct(server, table_keys, n_t, duration, conc, batch):
    batcher = server.manager._models["dlrm"].batchers[0]
    rng = np.random.default_rng(0)
    reqs = [np.concatenate([k[rng.integers(0, k.shape[0], batch)] for k in table_keys])
            for _ in range(64)]
    nk = [batch] * n_t
    counts = [0] * conc

    def client(cid, stop):
        i = cid
        while not stop.is_set():
            batcher.infer(reqs[i % len(reqs)], nk, timeout=60)
            counts[cid] += 1
            i += 1

    wall = _run_threads(client, conc, duration)
    return sum(counts), wall, None


def run_http(server, table_keys, n_t, duration, conc, batch):
    import http.client

    rng = np.random.default_rng(1)
    blobs = []
    for _ in range(64):
        keys = np.concatenate([k[rng.integers(0, k.shape[0], batch)] for k in table_keys])
        kraw = np.ascontiguousarray(keys, "<i8").tobytes()
        nraw = np.asarray([batch] * n_t, "<i4").tobytes()
        header = json.dumps({
            "inputs": [
                {"name": "KEYS", "datatype": "INT64", "shape": [keys.shape[0]],
                 "parameters": {"binary_data_size": len(kraw)}},
                {"name": "NUMKEYS", "datatype": "INT32", "shape": [n_t],
                 "parameters": {"binary_data_size": len(nraw)}},
            ],
            "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}],
        }).encode()
        blobs.append((header, kraw + nraw))
    counts = [0] * conc
    lat: list = []

    def client(cid, stop):
        # Persistent keep-alive connection (the server speaks HTTP/1.1);
        # per-request reconnects would measure TCP setup, not the front end.
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        i = cid
        while not stop.is_set():
            header, raw = blobs[i % len(blobs)]
            i += 1
            t0 = time.perf_counter()
            conn.request("POST", "/v2/models/dlrm/infer", body=header + raw, headers={
                "Content-Type": "application/octet-stream",
                "Inference-Header-Content-Length": str(len(header))})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"HTTP {resp.status} from the server")
            lat.append(time.perf_counter() - t0)
            counts[cid] += 1
        conn.close()

    wall = _run_threads(client, conc, duration)
    return sum(counts), wall, lat


def run_grpc(server, table_keys, n_t, duration, conc, batch):
    import grpc as grpc_mod

    from hugectr_backend_tpu_torch.serving import kserve_pb

    pb2 = kserve_pb.load()
    rng = np.random.default_rng(2)
    # Pre-serialize the request pool and skip client-side response parsing:
    # the SERVER is the system under test, and every client-side protobuf
    # cycle here steals the cores the server's codec runs on.
    wires = []
    for _ in range(64):
        keys = np.concatenate([k[rng.integers(0, k.shape[0], batch)] for k in table_keys])
        req = pb2.ModelInferRequest(model_name="dlrm")
        ki = req.inputs.add()
        ki.name, ki.datatype = "KEYS", "INT64"
        ki.shape.append(keys.shape[0])
        ni = req.inputs.add()
        ni.name, ni.datatype = "NUMKEYS", "INT32"
        ni.shape.append(n_t)
        req.raw_input_contents.append(np.ascontiguousarray(keys, "<i8").tobytes())
        req.raw_input_contents.append(np.asarray([batch] * n_t, "<i4").tobytes())
        wires.append(req.SerializeToString())
    counts = [0] * conc

    def client(cid, stop):
        channel = grpc_mod.insecure_channel(f"127.0.0.1:{server.grpc.port}")
        infer = channel.unary_unary(
            f"/{kserve_pb.SERVICE_NAME}/ModelInfer",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        i = cid
        while not stop.is_set():
            infer(wires[i % len(wires)], timeout=60)
            i += 1
            counts[cid] += 1
        channel.close()

    wall = _run_threads(client, conc, duration)
    return sum(counts), wall, None


LEGS = (
    ("direct_b64", run_direct, 64),   # 64-sample requests merged up to 256
    ("direct_b256", run_direct, 256),
    ("http_b64", run_http, 64),       # the shape of chip_smoke's frontend traffic
    ("http_b256", run_http, 256),
    ("grpc_b256", run_grpc, 256),
)


def concurrency(smoke: bool) -> int:
    """The legs' client count: 2 in smoke mode, else min(8, 2 x cores)."""
    return 2 if smoke else max(2, min(8, (os.cpu_count() or 1) * 2))


def run(device=None, smoke: bool = False, conc_scan=None) -> dict:
    """Boot the server on ``device``, stub the device out, run the legs at
    each client count of ``conc_scan`` (default: {2, concurrency(smoke)},
    the concurrency alone in smoke mode), keeping each leg's best.
    -> the report (every leg's line says the device is stubbed)."""
    from hugectr_backend_tpu_torch.serving import metrics as smetrics

    ncpu = os.cpu_count() or 1
    # Production serving hosts have many cores; report ncpu so the reader
    # can place these numbers.
    conc = concurrency(smoke)
    duration = 2.0 if smoke else 6.0
    with tempfile.TemporaryDirectory(prefix="hps_sat_") as root:
        server, table_keys, n_t = build_server(root, smoke, device)
        try:
            server_device = str(server.manager.ps.get_embedding_cache("dlrm", 0).device)
            stub_device(server)
            out = {
                "num_tables": n_t,
                "host_cpus": ncpu,
                "concurrency": conc,
                "duration_s": duration,
                "server_device": server_device,
                "device": STUBBED,
            }
            if conc_scan is None:
                conc_scan = [conc] if smoke else sorted({2, conc})
            out["concurrency_scan"] = list(conc_scan)
            for leg, fn, batch in LEGS:
                best = None
                for c in conc_scan:
                    sw_n0 = smetrics.BATCH_SW_SECONDS.count(model="dlrm")
                    sw_s0 = smetrics.BATCH_SW_SECONDS.sum(model="dlrm")
                    n, wall, lat = fn(server, table_keys, n_t, duration, c, batch)
                    batches = smetrics.BATCH_SW_SECONDS.count(model="dlrm") - sw_n0
                    sw_us = ((smetrics.BATCH_SW_SECONDS.sum(model="dlrm") - sw_s0)
                             / max(batches, 1) * 1e6)
                    cand = {
                        "batch_per_request": batch,
                        "concurrency": c,
                        "requests_per_s": n / wall,
                        "samples_per_s": n * batch / wall,
                        "merged_batches_per_s": batches / wall,
                        "merged_256_equiv_per_s": n * batch / wall / 256,
                        "sw_overhead_us_per_batch": sw_us,
                        "device": STUBBED,
                    }
                    if lat:
                        ms = np.asarray(lat) * 1e3
                        cand["p50_ms"] = float(np.percentile(ms, 50))
                        cand["p99_ms"] = float(np.percentile(ms, 99))
                    if best is None or cand["samples_per_s"] > best["samples_per_s"]:
                        best = cand
                out[leg] = best
                print(f"{leg} (device stubbed): {json.dumps(best)}", flush=True)
        finally:
            server.stop()
    out["note"] = (
        "the device is stubbed: every number is front-end software on the host "
        f"({ncpu} cores shared by the clients and the server). Direct legs isolate "
        "the batcher and the response split; http/grpc legs add the codec.")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the server boots: 'cpu', or a card (default cuda:0)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = run(args.device, smoke=bool(os.environ.get("HPS_SAT_SMOKE")))
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(f"frontend_saturation (device stubbed): {json.dumps(out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
