"""Profiling annotations: the reference's NVTX ranges, over ``torch.profiler``.

The reference wraps its hot sections in NVTX ranges (``NVTX_RANGE(nvtx_,
"ModelInstanceExecute...")``, reference hps_backend/src/hps.cc:375,671-675).
Port of the JAX package's utils/tracing.py: ``annotate`` is
``torch.profiler.record_function``, so a region shows as a named range in a
``torch.profiler`` trace, and as an NVTX range under
``torch.autograd.profiler.emit_nvtx()`` (Nsight).

    with annotate("ProcessBatch/dlrm"):
        ...
"""

from __future__ import annotations


def annotate(name: str):
    """Context manager marking a host-side region in profiler traces."""
    import torch.profiler

    return torch.profiler.record_function(name)
