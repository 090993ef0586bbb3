"""Load generator for the serving frontend — the ``perf_analyzer`` equivalent.

The reference CI smoke-tests with ``perf_analyzer -m dlrm --shape KEYS:26
--shape NUMKEYS:1`` (reference .gitlab-ci.yml:70). This tool drives the HTTP
or gRPC frontend (``-i grpc``, like ``perf_analyzer -i grpc``) with
concurrent clients and reports qps + latency percentiles as one JSON line.
A client: it touches no device (the server it drives decides where the
lookups run).

    python -m hugectr_backend_tpu_torch.tools.perf_client \
        --url http://127.0.0.1:8000 --model dlrm --keys-per-sample 26 \
        --batch 8 --concurrency 4 --duration 10 --key-range 100000
    python -m hugectr_backend_tpu_torch.tools.perf_client -i grpc \
        --url 127.0.0.1:8001 --model dlrm
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np


def _build_request(args, keys, n_keys):
    if args.binary:
        kraw = np.ascontiguousarray(keys, "<i8").tobytes()
        nraw = np.asarray([n_keys], "<i4").tobytes()
        header = json.dumps(
            {
                "inputs": [
                    {"name": "KEYS", "datatype": "INT64", "shape": [n_keys],
                     "parameters": {"binary_data_size": len(kraw)}},
                    {"name": "NUMKEYS", "datatype": "INT32", "shape": [1],
                     "parameters": {"binary_data_size": len(nraw)}},
                ],
                "outputs": [
                    {"name": "OUTPUT0", "parameters": {"binary_data": True}}
                ],
            }
        ).encode()
        body = header + kraw + nraw
        return body, {"Inference-Header-Content-Length": str(len(header))}
    req = {
        "inputs": [
            {"name": "KEYS", "datatype": "INT64", "shape": [n_keys],
             "data": keys.tolist()},
            {"name": "NUMKEYS", "datatype": "INT32", "shape": [1],
             "data": [n_keys]},
        ]
    }
    return json.dumps(req).encode(), {}


def run_client(args, stats, stop):
    rng = np.random.default_rng(threading.get_ident() & 0xFFFF)
    n_keys = args.batch * args.keys_per_sample
    url = f"{args.url}/v2/models/{args.model}/infer"
    while not stop.is_set():
        keys = rng.integers(0, args.key_range, n_keys)
        body, headers = _build_request(args, keys, n_keys)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                urllib.request.Request(url, body, headers=headers, method="POST"),
                timeout=30,
            ) as r:
                r.read()
            stats["lat"].append(time.perf_counter() - t0)
            stats["ok"] += 1
        except Exception:
            stats["err"] += 1


def run_client_grpc(args, stats, stop):
    import grpc

    from hugectr_backend_tpu_torch.serving import kserve_pb

    pb2 = kserve_pb.load()
    rng = np.random.default_rng(threading.get_ident() & 0xFFFF)
    n_keys = args.batch * args.keys_per_sample
    target = args.url.replace("http://", "").replace("grpc://", "")
    channel = grpc.insecure_channel(target)
    infer = channel.unary_unary(
        f"/{kserve_pb.SERVICE_NAME}/ModelInfer",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=pb2.ModelInferResponse.FromString,
    )
    while not stop.is_set():
        keys = rng.integers(0, args.key_range, n_keys)
        req = pb2.ModelInferRequest(model_name=args.model)
        ki = req.inputs.add()
        ki.name, ki.datatype = "KEYS", "INT64"
        ki.shape.append(n_keys)
        ni = req.inputs.add()
        ni.name, ni.datatype = "NUMKEYS", "INT32"
        ni.shape.append(1)
        req.raw_input_contents.append(
            np.ascontiguousarray(keys, "<i8").tobytes())
        req.raw_input_contents.append(np.asarray([n_keys], "<i4").tobytes())
        t0 = time.perf_counter()
        try:
            infer(req, timeout=30)
            stats["lat"].append(time.perf_counter() - t0)
            stats["ok"] += 1
        except Exception:
            stats["err"] += 1
    channel.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("-i", "--protocol", choices=["http", "grpc"],
                    default="http")
    ap.add_argument("--model", default="dlrm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--keys-per-sample", type=int, default=26)
    ap.add_argument("--key-range", type=int, default=100_000)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--binary", action="store_true",
                    help="KServe binary tensor extension (tritonclient wire format)")
    args = ap.parse_args(argv)

    stats = {"lat": [], "ok": 0, "err": 0}
    stop = threading.Event()
    worker = run_client_grpc if args.protocol == "grpc" else run_client
    threads = [
        threading.Thread(target=worker, args=(args, stats, stop), daemon=True)
        for _ in range(args.concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    wall = time.perf_counter() - t0
    lat = np.asarray(stats["lat"]) * 1e3
    out = {
        "requests_ok": stats["ok"],
        "requests_err": stats["err"],
        "qps": round(stats["ok"] / wall, 1),
        "samples_per_s": round(stats["ok"] * args.batch / wall, 1),
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 2) if len(lat) else None,
            "p90": round(float(np.percentile(lat, 90)), 2) if len(lat) else None,
            "p99": round(float(np.percentile(lat, 99)), 2) if len(lat) else None,
        },
        "concurrency": args.concurrency,
        "batch": args.batch,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
