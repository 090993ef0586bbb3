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
]
