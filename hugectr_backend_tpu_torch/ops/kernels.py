"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, so an edited kernel is rebuilt
and a stale library is never loaded. All sources compile in parallel (one
``nvcc`` each). A failed build raises; nothing falls back to PyTorch.

``launches[name]`` counts the launches of each kernel: a wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gather_dequant", "dot_interaction", "dot_interaction_bwd", "w8a8_dense",
           "onehot_gather")

#: Launch count per kernel (see the module docstring).
launches: "collections.Counter[str]" = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the CUDA "
        "kernels of hugectr_backend_tpu_torch are built from csrc/ at first use"
    )


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict:
    """Compile every missing library, all ``nvcc`` processes at once.
    -> {name: seconds spent building it} (0.0 when it was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
            "-o", str(tmp), str(CSRC / f"{name}.cu"),
        ]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    took = {name: 0.0 for name in SOURCES}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        # The compiler's report (registers, shared memory, spills) sits
        # beside the library.
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))
    return took


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.hps_cuda_error_string.restype = ctypes.c_char_p
    lib.hps_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not _target(name).exists():
                build_all()
            _libs[name] = _bind(ctypes.CDLL(str(_target(name))))
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.hps_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def forward_only(name: str, *tensors) -> None:
    """Raise when autograd would record ``name``: a kernel without a
    backward must not hand back a result cut from the graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (it has no backward): call it under "
            "torch.no_grad() or torch.inference_mode(), or on inputs that do "
            "not require grad")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
