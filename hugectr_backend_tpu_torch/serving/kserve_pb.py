"""Lazy protoc codegen for the KServe v2 gRPC protocol messages.

Port of the JAX package's serving/kserve_pb.py. ``load`` generates
``kserve_v2_pb2.py`` from this package's copy of ``kserve_v2.proto`` with
``protoc`` at first use, into the package's ignored ``_build/`` directory
(the file name carries a hash of the .proto, so an edited .proto is
regenerated). Only message codegen is needed: the service is wired by hand in
grpc_server.py through grpc generic method handlers, so grpcio-tools is not
required.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_HERE = pathlib.Path(__file__).resolve().parent
_PROTO = _HERE / "kserve_v2.proto"
BUILD_DIR = _HERE.parent / "_build"
_lock = threading.Lock()
_module = None

# Full service name clients address RPCs to (tritonclient.grpc compatible).
SERVICE_NAME = "inference.GRPCInferenceService"


def _target() -> pathlib.Path:
    digest = hashlib.sha1(_PROTO.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"kserve_v2_pb2-{digest}.py"


def _generate(out: pathlib.Path) -> None:
    protoc = shutil.which("protoc")
    if protoc is None:
        raise RuntimeError("protoc not found on PATH: the gRPC frontend generates "
                           "its messages from serving/kserve_v2.proto at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Generate into a private temp dir and publish with an atomic rename:
    # processes generating at once must never load a half-written pb2.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        proc = subprocess.run(
            [protoc, f"-I{_HERE}", f"--python_out={tmp}", _PROTO.name],
            cwd=_HERE, capture_output=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"protoc failed for {_PROTO.name}:\n"
                               f"{proc.stderr.decode(errors='replace')}")
        os.replace(pathlib.Path(tmp) / "kserve_v2_pb2.py", out)


def load():
    """Return the generated kserve_v2_pb2 module (codegen on first use)."""
    global _module
    if _module is not None:
        return _module
    with _lock:
        if _module is None:
            out = _target()
            if not out.exists():
                _generate(out)
            spec = importlib.util.spec_from_file_location("kserve_v2_pb2", out)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        return _module
