"""hugectr_backend_tpu_torch — the Hierarchical Parameter Server in PyTorch and CUDA.

A port of :mod:`hugectr_backend_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card. It mirrors the JAX package's module paths
(``tiers/hbm.py`` <-> ``tiers/hbm.py``) and its public entry points:

    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    ps = HierParameterServer.create("ps.json")          # caches on cuda:<dev>
    cache = ps.get_embedding_cache("dlrm", 0)
    session = LookupSession.create(ps.get_model_params("dlrm"), cache)
    vectors = session.lookup(keys_per_table, num_keys_per_table)

Entry points run on the card unless the caller passes ``device="cpu"``. The
Pallas kernels of the JAX package are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` at first use; each has a plain PyTorch
version beside it that serves CPU tensors.
"""

from hugectr_backend_tpu_torch.config.params import (
    DatabaseType,
    DatabaseOverflowPolicy,
    EmbeddingCacheType,
    InferenceParams,
    ParameterServerConfig,
    PersistentDatabaseParams,
    UpdateSourceParams,
    UpdateSourceType,
    VolatileDatabaseParams,
)

__version__ = "0.1.0"

__all__ = [
    "DatabaseType",
    "DatabaseOverflowPolicy",
    "EmbeddingCacheType",
    "InferenceParams",
    "ParameterServerConfig",
    "PersistentDatabaseParams",
    "UpdateSourceParams",
    "UpdateSourceType",
    "VolatileDatabaseParams",
    "HierParameterServer",
    "LookupSession",
]


def __getattr__(name):
    # Lazy so that config/io utilities import without torch's CUDA state.
    if name == "HierParameterServer":
        from hugectr_backend_tpu_torch.ps.parameter_server import HierParameterServer

        return HierParameterServer
    if name == "LookupSession":
        from hugectr_backend_tpu_torch.lookup.session import LookupSession

        return LookupSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
