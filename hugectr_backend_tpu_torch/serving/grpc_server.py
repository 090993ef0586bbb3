"""gRPC serving frontend: KServe-v2 `inference.GRPCInferenceService`.

Port of the JAX package's serving/grpc_server.py. Triton exposes this service
on port 8001 next to the HTTP endpoint on 8000; the reference's clients
(`tritonclient.grpc`, `perf_analyzer -i grpc`) speak it. The service shares
its ModelManager with the HTTP frontend (serving/server.py), so both ports
serve identical semantics:

  - KEYS (INT64) + NUMKEYS (INT32/INT64) -> OUTPUT0 (FP32), the reference's
    tensor contract (reference model_state.cpp:180-261).
  - Response parameters NumSample / DeviceID (reference hps.cc:712-719).
  - Repository index / load / unload (model-control-mode=explicit,
    reference README.md:161-168).

The service is wired with grpc generic method handlers over protoc-generated
messages (serving/kserve_pb.py) — no grpcio-tools codegen needed. ``grpc`` is
imported only when a server is built, so the HTTP frontend imports without
it. Ensembles and dense models (``ensembles=`` / ``dense_models=``, from a
model repository) serve ModelReady, ModelMetadata, RepositoryIndex and
ModelInfer beside the HPS models.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.pb_wire import NP_TO_DT, WIRE_DT, infer_response_bytes
from hugectr_backend_tpu_torch.serving.scheduler import RequestError
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.grpc")

# Which InferTensorContents field carries each datatype.
_CONTENTS_FIELD = {
    "BOOL": "bool_contents", "INT8": "int_contents", "INT16": "int_contents",
    "INT32": "int_contents", "INT64": "int64_contents",
    "UINT8": "uint_contents", "UINT16": "uint_contents",
    "UINT32": "uint_contents", "UINT64": "uint64_contents",
    "FP32": "fp32_contents", "FP64": "fp64_contents",
}

def _tensor_to_numpy(tensor, raw: Optional[bytes]):
    """Decode one InferInputTensor (raw bytes take precedence over contents)."""
    dt = tensor.datatype or "FP32"
    wire = WIRE_DT.get(dt)
    if wire is None:
        raise RequestError(f"unsupported datatype {dt!r}")
    if raw is not None:
        itemsize = np.dtype(wire).itemsize
        if len(raw) % itemsize:
            raise RequestError(
                f"tensor {tensor.name!r}: raw byte length {len(raw)} is not "
                f"a multiple of {dt} itemsize {itemsize}"
            )
        arr = np.frombuffer(raw, dtype=wire)
    else:
        field = _CONTENTS_FIELD.get(dt)
        if field is None:
            raise RequestError(f"unsupported contents datatype {dt!r}")
        arr = np.asarray(list(getattr(tensor.contents, field)),
                         dtype=np.dtype(wire))
    shape = [int(d) for d in tensor.shape]
    if shape and all(d >= 0 for d in shape):
        try:
            arr = arr.reshape(shape)
        except ValueError as e:
            raise RequestError(f"tensor {tensor.name!r}: {e}") from e
    return arr


class KServeGrpcService:
    """The RPC implementations. One instance per server; thread-safe by
    construction (ModelManager and metrics are already thread-safe)."""

    def __init__(self, manager: ModelManager, ensembles=None, dense_models=None):
        from hugectr_backend_tpu_torch.serving import kserve_pb

        self.manager = manager
        self.ensembles = dict(ensembles or {})
        self.dense_models = dict(dense_models or {})
        self.pb2 = kserve_pb.load()

    # -- health / metadata ----------------------------------------------------

    def server_live(self, request, context):
        return self.pb2.ServerLiveResponse(live=True)

    def server_ready(self, request, context):
        return self.pb2.ServerReadyResponse(ready=True)

    def server_metadata(self, request, context):
        return self.pb2.ServerMetadataResponse(
            name="hps_tpu", version="0.1.0",
            extensions=["model_repository", "binary_tensor_data", "statistics"],
        )

    def _model_ready(self, name: str) -> bool:
        if name in self.ensembles:
            return self.ensembles[name].ready()
        return name in self.dense_models or self.manager.is_loaded(name)

    def model_ready(self, request, context):
        return self.pb2.ModelReadyResponse(ready=self._model_ready(request.name))

    def model_metadata(self, request, context):
        pb2 = self.pb2
        name = request.name
        TM = pb2.ModelMetadataResponse.TensorMetadata
        named = self.ensembles.get(name, self.dense_models.get(name))
        if named is not None:
            md = named.metadata(name)
            return pb2.ModelMetadataResponse(
                name=name, versions=["1"], platform=md["platform"],
                inputs=[TM(**t) for t in md["inputs"]],
                outputs=[TM(**t) for t in md["outputs"]],
            )
        if not self.manager.is_loaded(name):
            import grpc

            context.abort(grpc.StatusCode.NOT_FOUND, f"model {name!r} not found")
        return pb2.ModelMetadataResponse(
            name=name, versions=["1"], platform="hps_tpu",
            inputs=[TM(name="KEYS", datatype="INT64", shape=[-1]),
                    TM(name="NUMKEYS", datatype="INT32", shape=[-1])],
            outputs=[TM(name="OUTPUT0", datatype="FP32", shape=[-1])],
        )

    # -- repository control ---------------------------------------------------

    def repository_index(self, request, context):
        pb2 = self.pb2
        MI = pb2.RepositoryIndexResponse.ModelIndex
        models = [
            MI(name=m["name"], version=str(m.get("version", "1")),
               state=m.get("state", "READY"))
            for m in self.manager.loaded_models()
        ]
        models += [MI(name=n, version="1", state="READY")
                   for n in sorted(self.dense_models)]
        models += [MI(name=n, version="1", state="READY")
                   for n in sorted(self.ensembles)]
        return pb2.RepositoryIndexResponse(models=models)

    def repository_model_load(self, request, context):
        version = None
        p = request.parameters.get("version")
        if p is not None:
            which = p.WhichOneof("parameter_choice")
            if which == "int64_param":
                version = int(p.int64_param)
            elif which == "string_param":
                # Coerce numeric strings so "2" == 2 for the version-change
                # comparison in ModelManager.load (a str-vs-int mismatch
                # would spuriously re-parse tiers and schedule refreshes).
                try:
                    version = int(p.string_param)
                except ValueError:
                    version = p.string_param
        try:
            self.manager.load(request.model_name, version=version)
        except (KeyError, ConfigError) as e:
            # ConfigError = unknown model in the PS config: NOT_FOUND, not
            # an internal fault.
            import grpc

            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return self.pb2.RepositoryModelLoadResponse()

    def repository_model_unload(self, request, context):
        try:
            self.manager.unload(request.model_name)
        except KeyError as e:
            import grpc

            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return self.pb2.RepositoryModelUnloadResponse()

    # -- inference -------------------------------------------------------------

    def model_infer(self, request, context):
        import grpc

        pb2 = self.pb2
        name = request.model_name
        raws = list(request.raw_input_contents)
        if raws and len(raws) != len(request.inputs):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "raw_input_contents must have one entry per input",
            )
        try:
            inputs = {
                t.name: _tensor_to_numpy(t, raws[i] if raws else None)
                for i, t in enumerate(request.inputs)
            }
        except RequestError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

        t0 = time.perf_counter()
        # HPS models are batcher-backed and the batcher already records
        # REQUEST_COUNT/LATENCY/FAIL per request — counting here again
        # doubled gRPC traffic's stats vs HTTP's. Ensembles and dense
        # models bypass the batcher, so this handler owns their metrics.
        tracked = name in self.ensembles or name in self.dense_models
        try:
            if name in self.ensembles:
                outputs = self.ensembles[name].infer(inputs)
                params = {}
            elif name in self.dense_models:
                dm = self.dense_models[name]
                missing = [n for n in dm.input_names if n not in inputs]
                if missing:
                    raise RequestError(f"input {missing[0]!r} is required")
                outputs = {dm.output_name: dm.forward_named(inputs)}
                params = {}
            else:
                if not self.manager.is_loaded(name):
                    context.abort(
                        grpc.StatusCode.NOT_FOUND, f"model {name!r} not found"
                    )
                if "KEYS" not in inputs or "NUMKEYS" not in inputs:
                    raise RequestError(
                        "inputs KEYS (INT64) and NUMKEYS (INT32) are required "
                        "(reference model_state.cpp:180-261)"
                    )
                # Reject datatype mismatches instead of silently coercing
                # (reference hps.cc:446-478; float keys would truncate) —
                # exactly the HTTP surface's contract: KEYS INT64,
                # NUMKEYS INT32.
                kdt = str(np.asarray(inputs["KEYS"]).dtype)
                if kdt != "int64":
                    raise RequestError(f"input KEYS must be INT64, got {kdt}")
                ndt = str(np.asarray(inputs["NUMKEYS"]).dtype)
                if ndt != "int32":
                    raise RequestError(f"input NUMKEYS must be INT32, got {ndt}")
                resp = self.manager.infer(
                    name,
                    np.asarray(inputs["KEYS"], np.int64).reshape(-1),
                    np.asarray(inputs["NUMKEYS"], np.int64).reshape(-1),
                )
                # Hot path: frame the response by hand straight from the
                # output buffer (serving/pb_wire.py — one copy instead of
                # the tobytes -> message -> SerializeToString three); the
                # method's response_serializer passes it through.
                out = np.ascontiguousarray(resp.output, dtype="<f4")
                return infer_response_bytes(
                    name, request.model_version or "1", request.id,
                    {"NumSample": resp.num_samples,
                     "DeviceID": resp.device_id},
                    "OUTPUT0", "FP32", [int(out.shape[0])], out,
                )
        except RequestError as e:
            if tracked:
                metrics.REQUEST_FAIL.inc(model=name)
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        if tracked:
            metrics.REQUEST_COUNT.inc(model=name)
            metrics.REQUEST_LATENCY.observe(
                time.perf_counter() - t0, model=name)

        out_tensors, out_raws = [], []
        for oname, arr in outputs.items():
            arr = np.asarray(arr)
            dt = NP_TO_DT.get(str(arr.dtype), "FP32")
            out_tensors.append(pb2.ModelInferResponse.InferOutputTensor(
                name=oname, datatype=dt, shape=list(arr.shape)))
            out_raws.append(
                np.ascontiguousarray(arr.astype(WIRE_DT[dt])).tobytes())
        return pb2.ModelInferResponse(
            model_name=name, model_version=request.model_version or "1",
            id=request.id, parameters=params,
            outputs=out_tensors, raw_output_contents=out_raws,
        )


class HpsGrpcServer:
    """gRPC server wrapper mirroring HpsHttpServer's lifecycle API."""

    def __init__(self, manager: ModelManager, host="127.0.0.1", port: int = 8001,
                 ensembles=None, dense_models=None, max_workers: int = 16,
                 tls_certfile=None, tls_keyfile=None):
        import grpc

        from hugectr_backend_tpu_torch.serving import kserve_pb

        pb2 = kserve_pb.load()
        svc = KServeGrpcService(manager, ensembles, dense_models)
        rpcs = {
            "ServerLive": (pb2.ServerLiveRequest, svc.server_live),
            "ServerReady": (pb2.ServerReadyRequest, svc.server_ready),
            "ServerMetadata": (pb2.ServerMetadataRequest, svc.server_metadata),
            "ModelReady": (pb2.ModelReadyRequest, svc.model_ready),
            "ModelMetadata": (pb2.ModelMetadataRequest, svc.model_metadata),
            "ModelInfer": (pb2.ModelInferRequest, svc.model_infer),
            "RepositoryIndex": (pb2.RepositoryIndexRequest, svc.repository_index),
            "RepositoryModelLoad":
                (pb2.RepositoryModelLoadRequest, svc.repository_model_load),
            "RepositoryModelUnload":
                (pb2.RepositoryModelUnloadRequest, svc.repository_model_unload),
        }
        handlers = {
            method: grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                # Pre-framed bytes pass through untouched — the ModelInfer
                # hot path hand-frames its response (serving/pb_wire.py;
                # cygrpc requires bytes, not bytearray).
                response_serializer=lambda msg: (
                    msg if isinstance(msg, bytes)
                    else msg.SerializeToString()
                ),
            )
            for method, (req_cls, fn) in rpcs.items()
        }
        self.server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="hps-grpc"),
        )
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                kserve_pb.SERVICE_NAME, handlers),
        ))
        if tls_certfile:
            with open(tls_keyfile, "rb") as f:
                key = f.read()
            with open(tls_certfile, "rb") as f:
                cert = f.read()
            creds = grpc.ssl_server_credentials([(key, cert)])
            self.port = self.server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = self.server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise RuntimeError(
                f"gRPC server failed to bind {host}:{port} "
                "(port already in use?)"
            )
        self.manager = manager
        self.service = svc

    def start(self):
        self.server.start()
        log.info("gRPC serving on port %d", self.port)
        return self

    def stop(self, grace: float = 2.0):
        self.server.stop(grace).wait()
