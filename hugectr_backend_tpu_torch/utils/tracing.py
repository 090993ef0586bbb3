"""Profiling annotations: the reference's NVTX ranges, over ``torch.profiler``.

The reference wraps its hot sections in NVTX ranges (``NVTX_RANGE(nvtx_,
"ModelInstanceExecute...")``, reference hps_backend/src/hps.cc:375,671-675).
Port of the JAX package's utils/tracing.py: ``annotate`` is
``torch.profiler.record_function``, so a region shows as a named range in a
``torch.profiler`` trace, and as an NVTX range under
``torch.autograd.profiler.emit_nvtx()`` (Nsight). ``start_trace`` /
``stop_trace`` record such a trace (host activity, and the card's where
there is one) and write it into a directory as a Chrome trace, which
Perfetto or ``chrome://tracing`` opens. ``HPS_TPU_DISABLE_TRACING`` ("1",
"true", "yes" or "on", read at each call) makes ``annotate`` a null
context.

    with annotate("ProcessBatch/dlrm"):
        ...
    start_trace("/tmp/hps_trace")
    ...
    stop_trace()   # -> /tmp/hps_trace/hps_trace_<pid>_<n>.json
"""

from __future__ import annotations

import contextlib
import os
import threading

_lock = threading.Lock()
_active = None  # (profiler, log_dir) between start_trace and stop_trace
_count = 0


def _tracing_disabled() -> bool:
    # Read per call, so that the switch works when set after import; "0" and
    # "false" leave tracing on, as every other switch of the package reads.
    return os.environ.get("HPS_TPU_DISABLE_TRACING", "").strip().lower() in (
        "1", "true", "yes", "on")


def annotate(name: str):
    """Context manager marking a host-side region in profiler traces."""
    if _tracing_disabled():
        return contextlib.nullcontext()
    import torch.profiler

    return torch.profiler.record_function(name)


def start_trace(log_dir: str) -> None:
    """Start recording a ``torch.profiler`` trace (CPU activity, and CUDA
    activity when a card is present) that :func:`stop_trace` writes into
    ``log_dir``. Raises if a trace is already being recorded."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _lock:
        if _active is not None:
            raise RuntimeError(f"a trace into {_active[1]!r} is already being recorded")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the trace that :func:`start_trace` began and write it into its
    directory as a Chrome trace. -> the file's path. Raises if no trace is
    being recorded."""
    global _active, _count
    with _lock:
        if _active is None:
            raise RuntimeError("no trace is being recorded (call start_trace first)")
        prof, log_dir = _active
        _active = None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        _count += 1
        path = os.path.join(log_dir, f"hps_trace_{os.getpid()}_{_count}.json")
        prof.export_chrome_trace(path)
    return path
