"""hugectr_backend_tpu_torch — the Hierarchical Parameter Server in PyTorch and CUDA.

A port of :mod:`hugectr_backend_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card. It mirrors the JAX package's module paths
(``tiers/hbm.py`` <-> ``tiers/hbm.py``) and its public entry points:

    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    ps = HierParameterServer.create("ps.json")          # caches on cuda:<dev>
    cache = ps.get_embedding_cache("dlrm", 0)
    session = LookupSession.create(ps.get_model_params("dlrm"), cache)
    vectors = session.lookup(keys_per_table, num_keys_per_table)

A DLRM with quantized dense layers (``DLRM(..., quant_fmt="w8a8" | "int8" |
"fp8")``, weights from ``models.quantize_model_params``) serves through the
same ``make_dlrm_multi_server``; ``io.DenseModel`` loads the dense-model
format both packages write. ``eval`` trains a DLRM with its embedding table
(``train_dlrm``, ``train_dlrm_multi``; the interaction's forward and
backward are kernels) and gates quantized serving on AUC
(``run_parity``, ``run_path_parity``).

``DLRM(..., compute_dtype=torch.bfloat16)`` runs its MLPs in bf16 and the
interaction kernels with bf16 in and out, as the JAX modules'
``compute_dtype``. ``python -m hugectr_backend_tpu_torch.bench`` is the
JAX package's headline benchmark on the card (the uncapped Criteo-Kaggle
tables, six dense variants, DIN, the tiers, HTTP and gRPC); its
microbenchmarks are ``scripts.microbench_*``.

The model zoo (``models``: WDL, DCN-v2, DeepFM, xDeepFM, NCF, MMoE, DIN,
BST, the two-tower user tower) serves through ``serving.program``'s
``make_*_server``, ``serving.pooled.FusedDinServer`` and
``serving.retrieval.RetrievalServer``, its lookups on the same gather kernel.

``serving.server`` serves a ps.json over KServe-v2 HTTP (and gRPC with
``grpcio``) through ``ModelManager`` and ``ContinuousBatcher``:
``python -m hugectr_backend_tpu_torch.serving.server ps.json --grpc-port -1``.
With ``--model-repository DIR`` it serves a Triton-style model repository
(``io.load_repository``): HPS models, dense models and the ensembles that
chain them (``serving.ensemble``; the one-table chain runs fused on the
card). Key translation, the DRAM stores, the quantizer and the batcher's
merge run on a native host library (``native/``, built with ``g++`` at first
use); ``volatile_db`` of type ``redis_cluster`` pools the DRAM of node
servers (``tiers.cluster``:
``python -m hugectr_backend_tpu_torch.tiers.cluster --port N``).

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
