"""HTTP serving frontend: KServe-v2-compatible inference API.

Port of the JAX package's serving/server.py: the same endpoints, status codes
and error bodies, JSON and binary-tensor protocols, TLS and command line,
over the port's ModelManager, with the ensembles and dense models of a
Triton-style model repository beside the HPS models. It serves on the card
unless ``serve`` (or ``ModelManager.create``) is given ``device="cpu"``:

    python -m hugectr_backend_tpu_torch.serving.server ps.json --grpc-port -1
    python -m hugectr_backend_tpu_torch.serving.server --model-repository DIR

Replaces the Triton server frontend the reference plugs into (reference
README.md:105-108 launches ``tritonserver``; clients use tritonclient.http
against the KServe v2 API). Endpoint surface mirrors what the reference's
notebooks exercise (health check ``curl /v2/health/ready``, repository index,
infer — reference samples/Hierarchical_Parameter_Server_Deployment.ipynb):

    GET  /v2/health/live
    GET  /v2/health/ready
    GET  /v2/models/<model>/ready
    GET  /v2/models/<model>                 (metadata)
    POST /v2/models/<model>/infer           (KServe v2 JSON tensors)
    POST /v2/repository/index
    POST /v2/repository/models/<model>/load
    POST /v2/repository/models/<model>/unload
    GET  /metrics                           (Prometheus, reference docs/metrics.md)

Infer request/response use the reference's tensor contract: inputs KEYS
(INT64) and NUMKEYS (INT32/INT64), output OUTPUT0 (FP32) — reference
model_state.cpp:180-261 validates exactly this schema; response parameters
carry NumSample and DeviceID like the reference (hps.cc:712-719).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.pb_wire import NP_TO_DT, WIRE_DT
from hugectr_backend_tpu_torch.serving.scheduler import RequestError
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.http")


class _Handler(BaseHTTPRequestHandler):
    manager: ModelManager = None  # set by HpsHttpServer
    ensembles: dict = {}          # name -> serving.ensemble.EnsembleServer
    dense_models: dict = {}       # name -> io.dense_model.DenseModel
    protocol_version = "HTTP/1.1"

    # -- helpers -------------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode())

    def _error(self, code: int, msg: str):
        self._json(code, {"error": msg})

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def log_message(self, fmt, *args):  # route access logs to our logger
        log.debug(fmt, *args)

    # -- GET -----------------------------------------------------------------

    def do_GET(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if parts == ["v2", "health", "live"]:
                return self._json(200, {})
            if parts == ["v2", "health", "ready"]:
                return self._json(200, {})
            if parts == ["metrics"]:
                return self._send(
                    200, metrics.REGISTRY.render().encode(), "text/plain; version=0.0.4"
                )
            if len(parts) == 4 and parts[:2] == ["v2", "models"] and parts[3] == "ready":
                name = parts[2]
                if name in self.ensembles:
                    if self.ensembles[name].ready():
                        return self._json(200, {})
                    return self._error(400, f"ensemble {name!r} not ready")
                if name in self.dense_models or self.manager.is_loaded(name):
                    return self._json(200, {})
                return self._error(400, f"model {name!r} not ready")
            if len(parts) == 4 and parts[:2] == ["v2", "models"] and parts[3] == "stats":
                # Per-model statistics (the reference reports these through
                # TRITONBACKEND_ModelInstanceReportStatistics -> Triton's
                # /v2/models/<m>/stats, hps.cc:740-761).
                name = parts[2]
                if not self.manager.is_loaded(name):
                    return self._error(404, f"model {name!r} not found")
                return self._json(
                    200,
                    {
                        "model_stats": [
                            {
                                "name": name,
                                "inference_count": metrics.REQUEST_COUNT.value(
                                    model=name
                                ),
                                "failure_count": metrics.REQUEST_FAIL.value(
                                    model=name
                                ),
                                "samples": metrics.SAMPLES_COUNT.value(
                                    model=name
                                ),
                                "latency_p50_s": metrics.REQUEST_LATENCY.percentile(
                                    0.5, model=name
                                ),
                                "latency_p99_s": metrics.REQUEST_LATENCY.percentile(
                                    0.99, model=name
                                ),
                                "queue_p50_s": metrics.QUEUE_LATENCY.percentile(
                                    0.5, model=name
                                ),
                            }
                        ]
                    },
                )
            if len(parts) == 4 and parts[:2] == ["v2", "models"] and parts[3] == "config":
                # Triton's model-configuration endpoint (tritonclient
                # get_model_config); reconstructs the config.pbtxt content.
                name = parts[2]
                named = self.ensembles.get(name, self.dense_models.get(name))
                if named is not None:
                    return self._json(200, named.config(name))
                if not self.manager.is_loaded(name):
                    return self._error(404, f"model {name!r} not found")
                p = self.manager.ps.get_model_params(name)
                return self._json(200, {
                    "name": name, "backend": "hps",
                    "max_batch_size": p.max_batch_size,
                    "input": [
                        {"name": "KEYS", "data_type": "TYPE_INT64", "dims": [-1]},
                        {"name": "NUMKEYS", "data_type": "TYPE_INT32", "dims": [-1]},
                    ],
                    "output": [
                        {"name": "OUTPUT0", "data_type": "TYPE_FP32", "dims": [-1]}
                    ],
                    "instance_group": [
                        {"count": p.num_of_worker_buffer_in_pool,
                         "kind": "KIND_GPU", "gpus": p.deployed_devices}
                    ],
                    "parameters": {
                        "refresh_interval":
                            {"string_value": str(p.refresh_interval)},
                        "refresh_delay": {"string_value": str(p.refresh_delay)},
                        "freeze_sparse":
                            {"string_value": str(p.freeze_sparse).lower()},
                    },
                })
            if len(parts) == 3 and parts[:2] == ["v2", "models"]:
                name = parts[2]
                named = self.ensembles.get(name, self.dense_models.get(name))
                if named is not None:
                    return self._json(200, named.metadata(name))
                if not self.manager.is_loaded(name):
                    return self._error(404, f"model {name!r} not found")
                p = self.manager.ps.get_model_params(name)
                return self._json(
                    200,
                    {
                        "name": name,
                        "platform": "hps_tpu",
                        "inputs": [
                            {"name": "KEYS", "datatype": "INT64", "shape": [-1]},
                            {"name": "NUMKEYS", "datatype": "INT32", "shape": [-1]},
                        ],
                        "outputs": [
                            {"name": "OUTPUT0", "datatype": "FP32", "shape": [-1]}
                        ],
                        "num_tables": p.num_tables,
                        "embedding_vecsize_per_table": p.embedding_vecsize_per_table,
                        "max_batch_size": p.max_batch_size,
                    },
                )
            if parts == ["v2"]:
                return self._json(
                    200, {"name": "hps_tpu", "version": "0.1.0", "extensions": []}
                )
            return self._error(404, f"unknown path {self.path}")
        except Exception as e:  # pragma: no cover
            log.exception("GET failed")
            return self._error(500, str(e))

    # -- POST ----------------------------------------------------------------

    def do_POST(self):
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if len(parts) == 4 and parts[:2] == ["v2", "models"] and parts[3] == "infer":
                name = parts[2]
                if name in self.ensembles:
                    return self._infer_named(name, self.ensembles[name].infer)
                if name in self.dense_models:
                    dm = self.dense_models[name]
                    return self._infer_named(
                        name,
                        lambda ins: {
                            dm.output_name: dm.forward(
                                np.asarray(ins[dm.input_name], np.float32)
                            )
                        },
                    )
                return self._infer(name)
            if parts == ["v2", "repository", "index"]:
                index = self.manager.loaded_models()
                index += [
                    {"name": n, "version": "1", "state": "READY"}
                    for n in sorted(self.dense_models)
                ]
                index += [
                    {"name": n, "version": "1", "state": "READY"}
                    for n in sorted(self.ensembles)
                ]
                return self._json(200, index)
            if (
                len(parts) == 5
                and parts[:3] == ["v2", "repository", "models"]
                and parts[4] in ("load", "unload")
            ):
                name = parts[3]
                body = self._read_body()
                version = None
                if body:
                    try:
                        req = json.loads(body)
                        version = (
                            req.get("parameters", {}).get("version") if req else None
                        )
                    except json.JSONDecodeError:
                        pass
                if isinstance(version, str):
                    # Coerce numeric strings so "2" == 2 in the
                    # version-change comparison (a str-vs-int mismatch
                    # would spuriously re-parse tiers and store a
                    # str-typed version) — same hazard the gRPC handler
                    # guards.
                    try:
                        version = int(version)
                    except ValueError:
                        pass
                if parts[4] == "load":
                    self.manager.load(name, version=version)
                else:
                    self.manager.unload(name)
                return self._json(200, {})
            return self._error(404, f"unknown path {self.path}")
        except RequestError as e:
            return self._error(400, str(e))
        except KeyError as e:
            return self._error(404, str(e))
        except ConfigError as e:
            # get_model_params raises ConfigError for unknown models — a
            # client addressing error, not a server fault.
            return self._error(404, str(e))
        except Exception as e:  # pragma: no cover
            log.exception("POST failed")
            return self._error(500, str(e))

    def _infer_named(self, model_name: str, infer_fn):
        """Generic KServe-v2 infer for models with arbitrary named tensors
        (ensembles, dense models). ``infer_fn(inputs dict) -> outputs dict``."""
        body = self._read_body()
        header_len = self.headers.get("Inference-Header-Content-Length")
        raw_tail = b""
        if header_len is not None:
            try:
                h = int(header_len)
            except ValueError:
                return self._error(400, "bad Inference-Header-Content-Length")
            body, raw_tail = body[:h], body[h:]
        try:
            req = json.loads(body)
        except json.JSONDecodeError as e:
            return self._error(400, f"bad JSON: {e}")
        inputs: dict[str, np.ndarray] = {}
        offset = 0
        try:
            for t in req.get("inputs", []):
                name = t.get("name")
                dt = t.get("datatype", "FP32")
                # HPS wire-contract datatypes are fixed (reference
                # hps.cc:446-478 rejects mismatches before touching data).
                want = {"KEYS": "INT64", "NUMKEYS": "INT32"}.get(name)
                if want is not None and dt != want:
                    return self._error(
                        400, f"input {name} must be {want}, got {dt}"
                    )
                shape = t.get("shape")
                bsize = t.get("parameters", {}).get("binary_data_size")
                if bsize is not None:
                    wire = WIRE_DT.get(dt)
                    if wire is None:
                        return self._error(400, f"unsupported datatype {dt}")
                    arr = np.frombuffer(raw_tail[offset : offset + bsize], wire)
                    offset += bsize
                else:
                    wire = WIRE_DT.get(dt, "<f4")
                    arr = np.asarray(t.get("data", []), dtype=np.dtype(wire))
                if shape:
                    dims = [int(d) for d in shape]
                    if any(d < 0 for d in dims):
                        # request shapes must be concrete (numpy would treat
                        # ANY negative as a reshape wildcard and silently
                        # accept it)
                        return self._error(
                            400, f"input {name}: negative dim in shape {dims}"
                        )
                    arr = arr.reshape(dims)
                inputs[name] = arr
        except (TypeError, ValueError) as e:
            return self._error(400, f"bad tensor data: {e}")

        t0 = time.perf_counter()
        try:
            outputs = infer_fn(inputs)
        except RequestError as e:
            metrics.REQUEST_FAIL.inc(model=model_name)
            return self._error(400, str(e))
        metrics.REQUEST_COUNT.inc(model=model_name)
        metrics.REQUEST_LATENCY.observe(
            time.perf_counter() - t0, model=model_name
        )

        want_binary = any(
            o.get("parameters", {}).get("binary_data")
            for o in req.get("outputs", [])
        )
        out_list, raws = [], []
        for oname, arr in outputs.items():
            arr = np.asarray(arr)
            dt = NP_TO_DT.get(str(arr.dtype), "FP32")
            entry = {
                "name": oname,
                "datatype": dt,
                "shape": [int(d) for d in arr.shape],
            }
            if want_binary:
                # ascontiguousarray with a target dtype converts only when
                # needed — no unconditional astype copy, no tobytes: the
                # buffers stream to the socket below.
                raw = np.ascontiguousarray(arr, np.dtype(WIRE_DT[dt]))
                entry["parameters"] = {"binary_data_size": raw.nbytes}
                raws.append(raw)
            else:
                entry["data"] = arr.reshape(-1).tolist()
            out_list.append(entry)
        header = {"model_name": model_name, "outputs": out_list}
        if want_binary:
            hdr = json.dumps(header).encode()
            total = len(hdr) + sum(r.nbytes for r in raws)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Inference-Header-Content-Length", str(len(hdr)))
            self.send_header("Content-Length", str(total))
            self.end_headers()
            self.wfile.write(hdr)
            for r in raws:
                self.wfile.write(memoryview(r).cast("B"))
            return None
        return self._json(200, header)

    def _infer(self, model_name: str):
        body = self._read_body()
        # KServe binary-tensor extension (what tritonclient/perf_analyzer use
        # in practice): JSON header of Inference-Header-Content-Length bytes,
        # followed by raw tensor bytes in input order.
        header_len = self.headers.get("Inference-Header-Content-Length")
        raw_tail = b""
        if header_len is not None:
            try:
                h = int(header_len)
            except ValueError:
                return self._error(400, "bad Inference-Header-Content-Length")
            body, raw_tail = body[:h], body[h:]
        try:
            req = json.loads(body)
        except json.JSONDecodeError as e:
            return self._error(400, f"bad JSON: {e}")
        tensors = {t.get("name"): t for t in req.get("inputs", [])}
        if "KEYS" not in tensors or "NUMKEYS" not in tensors:
            return self._error(
                400,
                "inputs KEYS (INT64) and NUMKEYS (INT32) are required "
                "(reference model_state.cpp:180-261)",
            )

        def tensor_data(order, name, dtype):
            t = tensors[name]
            # Datatype/shape validation before touching data (reference
            # hps.cc:446-478 rejects mismatched input properties).
            want = {"KEYS": "INT64", "NUMKEYS": "INT32"}[name]
            declared = t.get("datatype", want)
            if declared != want:
                raise ValueError(f"input {name} must be {want}, got {declared}")
            shape = t.get("shape")
            dims = None
            if shape is not None:
                dims = [int(d) for d in shape]
                if any(d < 0 for d in dims):
                    raise ValueError(
                        f"input {name}: negative dim in shape {dims}"
                    )
            bsize = t.get("parameters", {}).get("binary_data_size")
            if bsize is None:
                arr = np.asarray(t.get("data", []), dtype=dtype)
                if dims is not None and arr.size != int(np.prod(dims)):
                    raise ValueError(
                        f"input {name}: shape {dims} does not match "
                        f"{arr.size} data elements"
                    )
                return arr
            # Binary payloads appear in the declared input order.
            offset = 0
            for other in req.get("inputs", []):
                if other is t:
                    break
                offset += other.get("parameters", {}).get("binary_data_size", 0)
            buf = raw_tail[offset : offset + bsize]
            # Wire layout follows the tensor's DECLARED datatype; an
            # omitted datatype defaults to the contract type, same as the
            # validation above (defaulting to "" made a valid request fail
            # with a confusing 'unsupported binary datatype None').
            declared_dt = t.get("datatype", want)
            wire = {
                "INT64": "<i8", "INT32": "<i4", "INT16": "<i2", "INT8": "<i1",
                "UINT32": "<u4", "FP32": "<f4", "FP64": "<f8",
            }.get(declared_dt, None)
            if wire is None:
                raise ValueError(
                    f"unsupported binary datatype {declared_dt!r}")
            # copy=False: the wire layout for the contract types IS the
            # target dtype on little-endian hosts — no per-request copy.
            return np.frombuffer(buf, dtype=wire).astype(dtype, copy=False)

        try:
            keys = tensor_data(0, "KEYS", np.int64)
            numkeys = tensor_data(1, "NUMKEYS", np.int64)
        except (TypeError, ValueError, KeyError) as e:
            return self._error(400, f"bad tensor data: {e}")
        try:
            resp = self.manager.infer(model_name, keys, numkeys)
        except RequestError as e:
            return self._error(400, str(e))

        want_binary = any(
            o.get("parameters", {}).get("binary_data")
            for o in req.get("outputs", [])
        )
        out_t = {
            "name": "OUTPUT0",
            "datatype": "FP32",
            "shape": [int(resp.output.shape[0])],
        }
        header = {
            "model_name": model_name,
            "parameters": {"NumSample": resp.num_samples, "DeviceID": resp.device_id},
            "outputs": [out_t],
        }
        if want_binary:
            # Write the output buffer straight to the socket (no tobytes,
            # no header+payload concat — each was a full OUTPUT0 copy,
            # ~185 us per merged-256 on the dev host).
            raw = np.ascontiguousarray(resp.output, dtype="<f4")
            out_t["parameters"] = {"binary_data_size": raw.nbytes}
            hdr = json.dumps(header).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Inference-Header-Content-Length", str(len(hdr)))
            self.send_header("Content-Length", str(len(hdr) + raw.nbytes))
            self.end_headers()
            self.wfile.write(hdr)
            self.wfile.write(memoryview(raw).cast("B"))
            return None
        out_t["data"] = resp.output.tolist()
        return self._json(200, header)


class HpsHttpServer:
    """Threaded HTTP server wrapper with startup/shutdown control."""

    def __init__(self, manager: ModelManager, host="127.0.0.1", port: int = 8000,
                 ensembles=None, dense_models=None,
                 tls_certfile=None, tls_keyfile=None):
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "manager": manager,
                "ensembles": dict(ensembles or {}),
                "dense_models": dict(dense_models or {}),
            },
        )
        # Default listen backlog (5) drops connections under bursty client
        # concurrency — raise it to what a serving frontend expects.
        server_cls = type(
            "HpsThreadingHTTPServer", (ThreadingHTTPServer,),
            {"request_queue_size": 128},
        )
        self.httpd = server_cls((host, port), handler)
        if tls_certfile:
            # HTTPS frontend (Triton serves TLS through its endpoints; the
            # reference backend rides that — this is the equivalent knob).
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_certfile, tls_keyfile)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.port = self.httpd.server_address[1]
        self.manager = manager
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="hps-http"
        )
        self._thread.start()
        log.info("serving on port %d", self.port)
        return self

    def stop(self):
        # serve() may attach a gRPC frontend as ``self.grpc``; one stop()
        # tears down both frontends (block=False embedders call only this).
        grpc = getattr(self, "grpc", None)
        if grpc is not None:
            grpc.stop()
            self.grpc = None
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.manager.shutdown()


def serve(ps_source=None, host="127.0.0.1", port=8000, block=True,
          model_repository=None, grpc_port=None,
          tls_certfile=None, tls_keyfile=None, device=None):
    """Entry point: ``python -m hugectr_backend_tpu_torch.serving.server
    ps.json`` (the reference's ``tritonserver --backend-config=hps,ps=...``
    equivalent, README.md:105-108). Passing ``model_repository`` consumes a
    Triton-style model repository (``tritonserver --model-repository=...``):
    config.pbtxt per model + numeric version dirs, with ps.json at the repo
    root unless ``ps_source`` is given (io/model_repo.py); its dense models
    and ensembles serve beside the HPS models. ``grpc_port`` additionally
    serves the KServe v2 gRPC protocol (Triton's port-8001 surface) over the
    same manager and ensembles. ``device``: None serves on the card
    (``cuda:<id>`` per ``deployed_device_list`` id; raises with no card),
    ``"cpu"`` on the CPU."""
    ensembles = dense_models = None
    if model_repository is not None:
        from hugectr_backend_tpu_torch.io.model_repo import load_repository
        from hugectr_backend_tpu_torch.serving.ensemble import EnsembleServer

        bundle = load_repository(model_repository, ps_source, device=device)
        manager = ModelManager.create(bundle.ps_config, load_all=False, device=device)
        try:
            for name, version in bundle.hps_versions.items():
                manager.load(name, version=version)
            dense_models = bundle.dense
            ensembles = {
                name: EnsembleServer(spec, manager, bundle.dense)
                for name, spec in bundle.ensembles.items()
            }
        except BaseException:
            manager.shutdown()
            raise
    else:
        if ps_source is None:
            raise ValueError("either ps_source or model_repository is required")
        manager = ModelManager.create(ps_source, device=device)
    try:
        server = HpsHttpServer(
            manager, host, port, ensembles=ensembles, dense_models=dense_models,
            tls_certfile=tls_certfile, tls_keyfile=tls_keyfile,
        ).start()
    except BaseException:
        manager.shutdown()
        raise
    if grpc_port is not None:
        from hugectr_backend_tpu_torch.serving.grpc_server import HpsGrpcServer

        try:
            server.grpc = HpsGrpcServer(
                manager, host, grpc_port,
                ensembles=ensembles, dense_models=dense_models,
                tls_certfile=tls_certfile, tls_keyfile=tls_keyfile,
            ).start()
        except BaseException:
            server.stop()
            raise
    if block:
        try:
            server._thread.join()
        except KeyboardInterrupt:
            server.stop()  # also stops the attached gRPC frontend
    return server


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("ps_json", nargs="?", help="path to ps.json")
    ap.add_argument(
        "--model-repository",
        help="Triton-style model repository dir (config.pbtxt + version dirs); "
        "ps.json defaults to <repo>/ps.json",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument(
        "--grpc-port", type=int, default=8001,
        help="KServe v2 gRPC port (Triton default 8001); -1 disables",
    )
    ap.add_argument("--tls-cert", help="PEM certificate: serve HTTPS and "
                    "TLS gRPC instead of plaintext")
    ap.add_argument("--tls-key", help="PEM private key for --tls-cert")
    args = ap.parse_args()
    serve(args.ps_json, args.host, args.port,
          model_repository=args.model_repository,
          grpc_port=None if args.grpc_port < 0 else args.grpc_port,
          tls_certfile=args.tls_cert, tls_keyfile=args.tls_key)
