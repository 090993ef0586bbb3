"""The KServe v2 gRPC protocol messages, built from a compiled descriptor.

Port of the JAX package's serving/kserve_pb.py, which runs ``protoc`` at first
use. Here ``kserve_v2.desc`` (the ``FileDescriptorProto`` that ``protoc``
compiles from this package's ``kserve_v2.proto``, as its Python generator
embeds it, committed beside it) is turned into message classes by
protobuf's own builder, the calls a protoc-generated ``kserve_v2_pb2.py``
makes, so a machine without ``protoc`` serves gRPC too. After editing the
.proto, regenerate it with ``python -m
hugectr_backend_tpu_torch.serving.kserve_pb`` (needs ``protoc``;
tests/test_torch_grpc.py checks the two agree). Only messages are built: the
service is wired by hand in grpc_server.py through grpc generic method
handlers, so grpcio-tools is not required.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import tempfile
import threading
import types

_HERE = pathlib.Path(__file__).resolve().parent
PROTO = _HERE / "kserve_v2.proto"
DESCRIPTOR_FILE = _HERE / "kserve_v2.desc"
_lock = threading.Lock()
_module = None

# Full service name clients address RPCs to (tritonclient.grpc compatible).
SERVICE_NAME = "inference.GRPCInferenceService"


def load():
    """Return the kserve_v2_pb2 module (built on first use)."""
    global _module
    if _module is not None:
        return _module
    with _lock:
        if _module is None:
            from google.protobuf import descriptor_pool
            from google.protobuf.internal import builder

            mod = types.ModuleType("kserve_v2_pb2")
            mod.DESCRIPTOR = descriptor_pool.Default().AddSerializedFile(
                DESCRIPTOR_FILE.read_bytes())
            builder.BuildMessageAndEnumDescriptors(mod.DESCRIPTOR, mod.__dict__)
            builder.BuildTopDescriptorsAndMessages(mod.DESCRIPTOR, "kserve_v2_pb2",
                                                   mod.__dict__)
            _module = mod
        return _module


def compile_descriptor() -> bytes:
    """``protoc``'s compile of ``kserve_v2.proto``, serialized as its Python
    generator embeds it (no ``json_name``)."""
    from google.protobuf import descriptor_pb2

    protoc = shutil.which("protoc")
    if protoc is None:
        raise RuntimeError("protoc not found on PATH")
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "kserve_v2.fds"
        subprocess.run([protoc, f"-I{_HERE}", f"--descriptor_set_out={out}", PROTO.name],
                       cwd=_HERE, check=True, capture_output=True, timeout=120)
        (f,) = descriptor_pb2.FileDescriptorSet.FromString(out.read_bytes()).file

    def strip(messages):
        for m in messages:
            for field in m.field:
                field.ClearField("json_name")
            strip(m.nested_type)

    strip(f.message_type)
    return f.SerializeToString()


if __name__ == "__main__":
    DESCRIPTOR_FILE.write_bytes(compile_descriptor())
