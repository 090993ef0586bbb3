"""Parameter-server configuration schema (ps.json).

JSON-compatible with the reference's ps.json contract: every key parsed by the
reference backend's ``HPSBackend::ParseParameterServer``
(reference hps_backend/src/backend.cpp:103-526) and documented in reference
docs/hierarchical_parameter_server.md:89-646 is accepted here, with identical
defaults where the reference states them. Enum coercion mirrors the reference's
``TritonJsonHelper`` (reference hps_backend/src/triton_helpers.cpp:183-339),
including the accepted aliases for each enum value and the "missing required
key" error behavior (triton_helpers.cpp:36-40).

TPU-native reinterpretations (documented per-field below):
  - ``gpucache``/``gpucacheper``/``embedding_cache_type`` configure the HBM
    hot-row cache instead of a CUDA cache.
  - ``use_cuda_graph`` -> whether lookup/dense programs are jit-compiled once
    and reused (always true on TPU; kept for config compatibility).
  - ``volatile_db`` configures the host-DRAM tier; ``persistent_db`` the local
    SSD tier; ``update_source`` the streaming update ingestion.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Mapping, Sequence


class ConfigError(ValueError):
    """Raised for malformed / missing configuration values.

    Mirrors the reference's mandatory-key TRITONSERVER_Error
    (reference hps_backend/src/triton_helpers.cpp:36-40).
    """


# ---------------------------------------------------------------------------
# Enums (values + aliases follow reference triton_helpers.cpp:183-339)
# ---------------------------------------------------------------------------


class DatabaseType(str, enum.Enum):
    """Storage backend type for the volatile / persistent tiers.

    Reference enum + aliases: triton_helpers.cpp:183-248. On TPU the volatile
    types all map onto the host-DRAM tier (partitioned native hash map); the
    distinction kept is partitioning/concurrency behavior:
      - HASH_MAP: single partition.
      - PARALLEL_HASH_MAP: ``num_partitions`` partitions, parallel ops.
      - MULTI_PROCESS_HASH_MAP: shared-memory map (single-process JAX runtime
        serves many sessions; retained for config compatibility).
      - REDIS_CLUSTER: accepted and mapped to the sharded multi-host DRAM tier.
      - ROCKS_DB: persistent local-SSD store.
    """

    DISABLED = "disabled"
    HASH_MAP = "hash_map"
    PARALLEL_HASH_MAP = "parallel_hash_map"
    MULTI_PROCESS_HASH_MAP = "multi_process_hash_map"
    REDIS_CLUSTER = "redis_cluster"
    ROCKS_DB = "rocks_db"

    @classmethod
    def parse(cls, value: str) -> "DatabaseType":
        # Alias sets follow reference triton_helpers.cpp:190-240.
        aliases = {
            "disable": cls.DISABLED,
            "disabled": cls.DISABLED,
            "hash": cls.HASH_MAP,
            "hash_map": cls.HASH_MAP,
            "hashmap": cls.HASH_MAP,
            "parallel_hash_map": cls.PARALLEL_HASH_MAP,
            "parallel_hashmap": cls.PARALLEL_HASH_MAP,
            "parallel_hash": cls.PARALLEL_HASH_MAP,
            "multi_process_hash_map": cls.MULTI_PROCESS_HASH_MAP,
            "multi_process_hashmap": cls.MULTI_PROCESS_HASH_MAP,
            "redis": cls.REDIS_CLUSTER,
            "redis_cluster": cls.REDIS_CLUSTER,
            "rocksdb": cls.ROCKS_DB,
            "rocks_db": cls.ROCKS_DB,
        }
        key = str(value).strip().lower()
        if key not in aliases:
            raise ConfigError(f"Unknown database type: {value!r}")
        return aliases[key]


class DatabaseOverflowPolicy(str, enum.Enum):
    """Eviction policy when a volatile tier exceeds ``overflow_margin``.

    Reference enum + aliases: triton_helpers.cpp:250-298.
    """

    EVICT_RANDOM = "evict_random"
    EVICT_LEAST_USED = "evict_least_used"
    EVICT_OLDEST = "evict_oldest"

    @classmethod
    def parse(cls, value: str) -> "DatabaseOverflowPolicy":
        aliases = {
            "evict_random": cls.EVICT_RANDOM,
            "random": cls.EVICT_RANDOM,
            "evict_least_used": cls.EVICT_LEAST_USED,
            "least_used": cls.EVICT_LEAST_USED,
            "lru": cls.EVICT_LEAST_USED,
            "evict_oldest": cls.EVICT_OLDEST,
            "oldest": cls.EVICT_OLDEST,
            "fifo": cls.EVICT_OLDEST,
        }
        key = str(value).strip().lower()
        if key not in aliases:
            raise ConfigError(f"Unknown overflow policy: {value!r}")
        return aliases[key]


class UpdateSourceType(str, enum.Enum):
    """Online-update ingestion source. Reference: triton_helpers.cpp:300-339."""

    NONE = "null"
    KAFKA_MESSAGE_QUEUE = "kafka_message_queue"
    # TPU-native addition: a durable file-backed queue usable without Kafka
    # brokers (same Producer/Source API; see hugectr_backend_tpu/update/).
    FILE_QUEUE = "file_queue"

    @classmethod
    def parse(cls, value: str) -> "UpdateSourceType":
        aliases = {
            "none": cls.NONE,
            "null": cls.NONE,
            "kafka": cls.KAFKA_MESSAGE_QUEUE,
            "kafka_mq": cls.KAFKA_MESSAGE_QUEUE,
            "kafka_message_queue": cls.KAFKA_MESSAGE_QUEUE,
            "file": cls.FILE_QUEUE,
            "file_queue": cls.FILE_QUEUE,
        }
        key = str(value).strip().lower()
        if key not in aliases:
            raise ConfigError(f"Unknown update source type: {value!r}")
        return aliases[key]


class EmbeddingCacheType(str, enum.Enum):
    """Hot-cache flavor. Reference: backend.cpp:483-491 (static|uvm|stochastic|dynamic).

    TPU mapping:
      - STATIC: top-``cache_size_percentage`` rows pinned in HBM; no online
        insert (fastest probe; direct slot addressing).
      - DYNAMIC: HBM hot cache with online insert/evict driven by misses.
      - UVM: full table resident in host DRAM with HBM hot rows + async
        host->HBM refill (closest analogue of CUDA unified memory).
      - STOCHASTIC: DYNAMIC with probabilistic (sampled) insertion to bound
        insert bandwidth.
    """

    STATIC = "static"
    DYNAMIC = "dynamic"
    UVM = "uvm"
    STOCHASTIC = "stochastic"

    @classmethod
    def parse(cls, value: str) -> "EmbeddingCacheType":
        key = str(value).strip().lower()
        try:
            return cls(key)
        except ValueError:
            raise ConfigError(f"Unknown embedding cache type: {value!r}") from None


# ---------------------------------------------------------------------------
# Coercion helpers (string-fallback behavior mirrors triton_helpers.cpp:42-178)
# ---------------------------------------------------------------------------


def _get(obj: Mapping[str, Any], key: str, default: Any, required: bool, caster):
    if key not in obj or obj[key] is None:
        if required:
            raise ConfigError(f"The parameter '{key}' is mandatory and missing")
        return default
    try:
        return caster(obj[key])
    except (TypeError, ValueError) as e:
        raise ConfigError(f"Bad value for parameter '{key}': {obj[key]!r} ({e})") from e


def _as_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


def _as_int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return int(v)
    return int(str(v).strip())


def _as_float(v: Any) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    return float(str(v).strip())


def _as_str(v: Any) -> str:
    return str(v)


def _as_str_list(v: Any) -> list[str]:
    if isinstance(v, str):
        return [v]
    return [str(x) for x in v]


def _as_int_list(v: Any) -> list[int]:
    if isinstance(v, (int, float)):
        return [int(v)]
    return [_as_int(x) for x in v]


def _as_float_list(v: Any) -> list[float]:
    if isinstance(v, (int, float)):
        return [float(v)]
    return [_as_float(x) for x in v]


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VolatileDatabaseParams:
    """Host-DRAM tier configuration.

    Field set + defaults mirror the reference's volatile_db block parsing
    (reference backend.cpp:130-216; docs/hierarchical_parameter_server.md:400-512).
    """

    type: DatabaseType = DatabaseType.PARALLEL_HASH_MAP
    # redis_cluster / distributed settings (backend.cpp:138-158)
    address: str = "127.0.0.1:7000"
    user_name: str = "default"
    password: str = ""
    num_partitions: int = 0  # 0 -> min(cpu_count, 16), cf. doc:403-415
    allocation_rate: int = 256 * 1024 * 1024  # bytes per allocation chunk
    shared_memory_size: int = 16 * 1024 * 1024 * 1024
    shared_memory_name: str = "hctr_mp_hash_map_database"
    shared_memory_auto_remove: bool = True
    max_batch_size: int = 64 * 1024  # chunking for bulk ops (doc:446-448)
    enable_tls: bool = False
    tls_ca_certificate: str = "cacertbundle.crt"
    tls_client_certificate: str = "client_cert.pem"
    tls_client_key: str = "client_key.pem"
    tls_server_name_identification: str = "redis.localhost"
    # overflow handling (backend.cpp:178-192; doc:460-487)
    overflow_margin: int = 2**63 - 1
    overflow_policy: DatabaseOverflowPolicy = DatabaseOverflowPolicy.EVICT_RANDOM
    overflow_resolution_target: float = 0.8
    # startup / caching behavior (backend.cpp:194-216; doc:488-512)
    initial_cache_rate: float = 1.0
    initialize_after_startup: bool = True
    cache_missed_embeddings: bool = False
    update_filters: list[str] = dataclasses.field(default_factory=lambda: ["^hps_.+$"])

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "VolatileDatabaseParams":
        d = cls()
        d.type = _get(obj, "type", d.type, False, DatabaseType.parse)
        d.address = _get(obj, "address", d.address, False, _as_str)
        d.user_name = _get(obj, "user_name", d.user_name, False, _as_str)
        d.password = _get(obj, "password", d.password, False, _as_str)
        d.num_partitions = _get(obj, "num_partitions", d.num_partitions, False, _as_int)
        d.allocation_rate = _get(obj, "allocation_rate", d.allocation_rate, False, _as_int)
        d.shared_memory_size = _get(
            obj, "shared_memory_size", d.shared_memory_size, False, _as_int
        )
        d.shared_memory_name = _get(
            obj, "shared_memory_name", d.shared_memory_name, False, _as_str
        )
        d.shared_memory_auto_remove = _get(
            obj, "shared_memory_auto_remove", d.shared_memory_auto_remove, False, _as_bool
        )
        d.max_batch_size = _get(obj, "max_batch_size", d.max_batch_size, False, _as_int)
        d.enable_tls = _get(obj, "enable_tls", d.enable_tls, False, _as_bool)
        d.tls_ca_certificate = _get(
            obj, "tls_ca_certificate", d.tls_ca_certificate, False, _as_str
        )
        d.tls_client_certificate = _get(
            obj, "tls_client_certificate", d.tls_client_certificate, False, _as_str
        )
        d.tls_client_key = _get(obj, "tls_client_key", d.tls_client_key, False, _as_str)
        d.tls_server_name_identification = _get(
            obj,
            "tls_server_name_identification",
            d.tls_server_name_identification,
            False,
            _as_str,
        )
        d.overflow_margin = _get(obj, "overflow_margin", d.overflow_margin, False, _as_int)
        d.overflow_policy = _get(
            obj, "overflow_policy", d.overflow_policy, False, DatabaseOverflowPolicy.parse
        )
        d.overflow_resolution_target = _get(
            obj, "overflow_resolution_target", d.overflow_resolution_target, False, _as_float
        )
        d.initial_cache_rate = _get(
            obj, "initial_cache_rate", d.initial_cache_rate, False, _as_float
        )
        d.initialize_after_startup = _get(
            obj, "initialize_after_startup", d.initialize_after_startup, False, _as_bool
        )
        d.cache_missed_embeddings = _get(
            obj, "cache_missed_embeddings", d.cache_missed_embeddings, False, _as_bool
        )
        d.update_filters = _get(obj, "update_filters", d.update_filters, False, _as_str_list)
        return d

    def effective_num_partitions(self) -> int:
        if self.num_partitions > 0:
            return self.num_partitions
        # Reference default: min(cores, 16) (doc:403-415).
        return min(os.cpu_count() or 1, 16)


@dataclasses.dataclass
class PersistentDatabaseParams:
    """Local-SSD tier configuration.

    Mirrors the reference persistent_db block (backend.cpp:220-259;
    docs/hierarchical_parameter_server.md:548-573). ``type=rocks_db`` maps to
    the native log-structured SSD store in hugectr_backend_tpu/tiers/ssd.py.
    """

    type: DatabaseType = DatabaseType.DISABLED
    path: str = "/tmp/rocksdb"
    num_threads: int = 16
    read_only: bool = False
    max_batch_size: int = 64 * 1024
    update_filters: list[str] = dataclasses.field(default_factory=lambda: ["^hps_.+$"])

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "PersistentDatabaseParams":
        d = cls()
        d.type = _get(obj, "type", d.type, False, DatabaseType.parse)
        d.path = _get(obj, "path", d.path, False, _as_str)
        d.num_threads = _get(obj, "num_threads", d.num_threads, False, _as_int)
        d.read_only = _get(obj, "read_only", d.read_only, False, _as_bool)
        d.max_batch_size = _get(obj, "max_batch_size", d.max_batch_size, False, _as_int)
        d.update_filters = _get(obj, "update_filters", d.update_filters, False, _as_str_list)
        return d


@dataclasses.dataclass
class UpdateSourceParams:
    """Online-update ingestion configuration.

    Mirrors the reference update_source block (backend.cpp:263-308;
    docs/hierarchical_parameter_server.md:575-646).
    """

    type: UpdateSourceType = UpdateSourceType.NONE
    brokers: str = "127.0.0.1:9092"
    metadata_refresh_interval_ms: int = 30_000
    receive_buffer_size: int = 256 * 1024
    poll_timeout_ms: int = 500
    max_batch_size: int = 8 * 1024
    failure_backoff_ms: int = 50
    max_commit_interval: int = 32
    compression_type: str = "none"  # producer-side codec (gzip/snappy/lz4/zstd)
    consumer_group_id: str = ""  # "" = node-local offsets (no coordination)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "UpdateSourceParams":
        d = cls()
        d.type = _get(obj, "type", d.type, False, UpdateSourceType.parse)
        d.brokers = _get(obj, "brokers", d.brokers, False, _as_str)
        d.metadata_refresh_interval_ms = _get(
            obj,
            "metadata_refresh_interval_ms",
            d.metadata_refresh_interval_ms,
            False,
            _as_int,
        )
        d.receive_buffer_size = _get(
            obj, "receive_buffer_size", d.receive_buffer_size, False, _as_int
        )
        d.poll_timeout_ms = _get(obj, "poll_timeout_ms", d.poll_timeout_ms, False, _as_int)
        d.max_batch_size = _get(obj, "max_batch_size", d.max_batch_size, False, _as_int)
        d.failure_backoff_ms = _get(
            obj, "failure_backoff_ms", d.failure_backoff_ms, False, _as_int
        )
        d.max_commit_interval = _get(
            obj, "max_commit_interval", d.max_commit_interval, False, _as_int
        )
        d.compression_type = _get(
            obj, "compression_type", d.compression_type, False, _as_str
        )
        d.consumer_group_id = _get(
            obj, "consumer_group_id", d.consumer_group_id, False, _as_str
        )
        return d


@dataclasses.dataclass
class InferenceParams:
    """Per-model deployment parameters.

    Field set mirrors the reference per-model block parsing
    (reference backend.cpp:318-523) and the InferenceParams contract
    (docs/hierarchical_parameter_server.md:129-289). Mandatory keys match the
    reference: model, sparse_files, embedding_vecsize_per_table,
    maxnum_catfeature_query_per_table_per_sample.

    TPU reinterpretations:
      - ``deployed_device_list`` indexes into ``jax.devices()``.
      - ``use_cuda_graph`` -> programs are jit-compiled & cached (always done).
      - ``fp8_quant`` selects FP8 (e4m3) row quantization instead of INT8
        (reference backend.cpp:500-504).
      - ``use_mixed_precision`` -> the fused dense forward's matmuls run in
        bf16 on the MXU with f32 params (serving/program.py), the TPU
        analogue of the reference's FP16 dense path.
      - ``scaler`` is ACCEPTED BUT INERT: it is the reference's training
        loss-scale for mixed precision; inference has no loss to scale.
      - ``enable_pagelock`` is ACCEPTED BUT INERT: JAX/TPU host transfers
        already stage through runtime-managed pinned buffers, so there is
        no user-level pagelock toggle to wire.
    """

    model_name: str = ""
    network_file: str = ""
    max_batch_size: int = 64
    dense_file: str = ""
    sparse_files: list[str] = dataclasses.field(default_factory=list)
    use_gpu_embedding_cache: bool = True  # "gpucache" -> HBM hot cache on/off
    hit_rate_threshold: float = 0.9  # async-insert switch (doc:175-179)
    cache_size_percentage: float = 0.5  # "gpucacheper" (doc:198-199)
    num_of_worker_buffer_in_pool: int = 2
    num_of_refresher_buffer_in_pool: int = 1
    cache_refresh_percentage_per_iteration: float = 0.1  # doc:234-238
    deployed_devices: list[int] = dataclasses.field(default_factory=lambda: [0])
    default_value_for_each_table: list[float] = dataclasses.field(
        default_factory=lambda: [0.0]
    )
    maxnum_des_feature_per_sample: int = 26
    maxnum_catfeature_query_per_table_per_sample: list[int] = dataclasses.field(
        default_factory=list
    )
    embedding_vecsize_per_table: list[int] = dataclasses.field(default_factory=list)
    embedding_table_names: list[str] = dataclasses.field(default_factory=list)
    label_dim: int = 1
    slot_num: int = 10
    embedding_cache_type: EmbeddingCacheType = EmbeddingCacheType.DYNAMIC
    use_context_stream: bool = True  # "init_ec" companion flag kept for compat
    init_ec: bool = True
    fp8_quant: bool = False
    enable_pagelock: bool = False
    # InferenceParams extras (doc:129-289)
    i64_input_key: bool = True
    use_mixed_precision: bool = False
    scaler: float = 1.0
    use_algorithm_search: bool = True
    use_cuda_graph: bool = True  # -> compiled-program reuse on TPU
    thread_pool_size: int = 16
    refresh_delay: float = 0.0
    refresh_interval: float = 0.0
    # config.pbtxt parameters{freeze_sparse} in the reference
    # (model_state.cpp:313-335): freeze skips tier re-load on refresh.
    freeze_sparse: bool = False
    # Continuous-batching frontend knobs (replaces Triton dynamic batching).
    max_queue_delay_us: int = 300
    # TPU-native extensions (not in reference ps.json; safe defaults)
    quant_bits: int = 8  # 4 (int4 packed) | 8 (int8) | 16 (bf16) | 32 (fp32); fp8_quant overrides
    table_shard_axis: str = "table"  # mesh axis name for sharded tables
    # Capacity partitioning: row-shard every table of this model across the
    # devices in deployed_device_list and serve with ICI-collective lookups
    # (parallel/sharded_table.py). The TPU translation of the reference's
    # multi-node volatile-db partitioning (``num_partitions``, reference
    # docs/hierarchical_parameter_server.md:435-444) — there capacity scales
    # by adding Redis nodes queried over RPC; here by sharding over the
    # mesh's aggregate HBM inside one XLA program.
    shard_tables: bool = False
    num_shards: int = 0  # 0 -> len(deployed_device_list)
    shard_strategy: str = "all_to_all"  # or "psum" (parallel/sharded_table.py)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "InferenceParams":
        d = cls()
        d.model_name = _get(obj, "model", "", True, _as_str)
        d.network_file = _get(obj, "network_file", d.network_file, False, _as_str)
        d.max_batch_size = _get(obj, "max_batch_size", d.max_batch_size, False, _as_int)
        d.dense_file = _get(obj, "dense_file", d.dense_file, False, _as_str)
        d.sparse_files = _get(obj, "sparse_files", None, True, _as_str_list)
        d.use_gpu_embedding_cache = _get(
            obj, "gpucache", d.use_gpu_embedding_cache, False, _as_bool
        )
        d.hit_rate_threshold = _get(
            obj, "hit_rate_threshold", d.hit_rate_threshold, False, _as_float
        )
        d.cache_size_percentage = _get(
            obj, "gpucacheper", d.cache_size_percentage, False, _as_float
        )
        d.num_of_worker_buffer_in_pool = _get(
            obj, "num_of_worker_buffer_in_pool", d.num_of_worker_buffer_in_pool, False, _as_int
        )
        d.num_of_refresher_buffer_in_pool = _get(
            obj,
            "num_of_refresher_buffer_in_pool",
            d.num_of_refresher_buffer_in_pool,
            False,
            _as_int,
        )
        d.cache_refresh_percentage_per_iteration = _get(
            obj,
            "cache_refresh_percentage_per_iteration",
            d.cache_refresh_percentage_per_iteration,
            False,
            _as_float,
        )
        d.deployed_devices = _get(
            obj, "deployed_device_list", d.deployed_devices, False, _as_int_list
        )
        d.default_value_for_each_table = _get(
            obj,
            "default_value_for_each_table",
            d.default_value_for_each_table,
            False,
            _as_float_list,
        )
        d.maxnum_des_feature_per_sample = _get(
            obj,
            "maxnum_des_feature_per_sample",
            d.maxnum_des_feature_per_sample,
            False,
            _as_int,
        )
        d.maxnum_catfeature_query_per_table_per_sample = _get(
            obj,
            "maxnum_catfeature_query_per_table_per_sample",
            None,
            True,
            _as_int_list,
        )
        d.embedding_vecsize_per_table = _get(
            obj, "embedding_vecsize_per_table", None, True, _as_int_list
        )
        d.embedding_table_names = _get(
            obj, "embedding_table_names", d.embedding_table_names, False, _as_str_list
        )
        d.label_dim = _get(obj, "label_dim", d.label_dim, False, _as_int)
        d.slot_num = _get(obj, "slot_num", d.slot_num, False, _as_int)
        d.embedding_cache_type = _get(
            obj,
            "embedding_cache_type",
            d.embedding_cache_type,
            False,
            EmbeddingCacheType.parse,
        )
        d.init_ec = _get(obj, "init_ec", d.init_ec, False, _as_bool)
        d.fp8_quant = _get(obj, "fp8_quant", d.fp8_quant, False, _as_bool)
        d.enable_pagelock = _get(obj, "enable_pagelock", d.enable_pagelock, False, _as_bool)
        d.i64_input_key = _get(obj, "i64_input_key", d.i64_input_key, False, _as_bool)
        d.use_mixed_precision = _get(
            obj, "use_mixed_precision", d.use_mixed_precision, False, _as_bool
        )
        d.scaler = _get(obj, "scaler", d.scaler, False, _as_float)
        d.use_algorithm_search = _get(
            obj, "use_algorithm_search", d.use_algorithm_search, False, _as_bool
        )
        d.use_cuda_graph = _get(obj, "use_cuda_graph", d.use_cuda_graph, False, _as_bool)
        d.thread_pool_size = _get(obj, "thread_pool_size", d.thread_pool_size, False, _as_int)
        d.refresh_delay = _get(obj, "refresh_delay", d.refresh_delay, False, _as_float)
        d.refresh_interval = _get(
            obj, "refresh_interval", d.refresh_interval, False, _as_float
        )
        d.freeze_sparse = _get(obj, "freeze_sparse", d.freeze_sparse, False, _as_bool)
        d.max_queue_delay_us = _get(
            obj, "max_queue_delay_us", d.max_queue_delay_us, False, _as_int
        )
        d.quant_bits = _get(obj, "quant_bits", d.quant_bits, False, _as_int)
        d.table_shard_axis = _get(obj, "table_shard_axis", d.table_shard_axis, False, _as_str)
        d.shard_tables = _get(obj, "shard_tables", d.shard_tables, False, _as_bool)
        d.num_shards = _get(obj, "num_shards", d.num_shards, False, _as_int)
        d.shard_strategy = _get(
            obj, "shard_strategy", d.shard_strategy, False, _as_str
        )
        d.validate()
        return d

    # -- derived quantities used throughout (reference model_state.cpp:337-356) --

    @property
    def num_tables(self) -> int:
        return len(self.sparse_files) if self.sparse_files else len(
            self.embedding_vecsize_per_table
        )

    @property
    def cat_num(self) -> int:
        """Total categorical features per sample = sum over tables of the
        per-table max query count (reference model_state.cpp:337-344)."""
        return sum(self.maxnum_catfeature_query_per_table_per_sample)

    @property
    def embedding_size(self) -> int:
        """Sum of per-table embedding vector sizes (model_state.cpp:352-356)."""
        return sum(self.embedding_vecsize_per_table)

    @property
    def max_result_floats_per_sample(self) -> int:
        """Output floats per sample = sum_t vecsize_t * maxcat_t
        (reference model_instance_state.cpp:136-152)."""
        return sum(
            v * c
            for v, c in zip(
                self.embedding_vecsize_per_table,
                self.maxnum_catfeature_query_per_table_per_sample,
            )
        )

    def default_value_for_table(self, table_idx: int) -> float:
        """Per-table miss default; a single scalar broadcasts to all tables
        (reference docs/hierarchical_parameter_server.md default_value_for_each_table)."""
        dv = self.default_value_for_each_table
        if not dv:
            return 0.0
        if table_idx < len(dv):
            return dv[table_idx]
        return dv[-1]

    def table_name(self, table_idx: int) -> str:
        if table_idx < len(self.embedding_table_names):
            return self.embedding_table_names[table_idx]
        return f"sparse_embedding{table_idx}"

    def validate(self) -> None:
        n = len(self.sparse_files)
        if n == 0:
            raise ConfigError(f"model {self.model_name!r}: sparse_files must be non-empty")
        if len(self.embedding_vecsize_per_table) != n:
            raise ConfigError(
                f"model {self.model_name!r}: embedding_vecsize_per_table has "
                f"{len(self.embedding_vecsize_per_table)} entries, expected {n}"
            )
        if len(self.maxnum_catfeature_query_per_table_per_sample) != n:
            raise ConfigError(
                f"model {self.model_name!r}: maxnum_catfeature_query_per_table_per_sample "
                f"has {len(self.maxnum_catfeature_query_per_table_per_sample)} entries, "
                f"expected {n}"
            )
        if self.embedding_table_names and len(self.embedding_table_names) != n:
            raise ConfigError(
                f"model {self.model_name!r}: embedding_table_names has "
                f"{len(self.embedding_table_names)} entries, expected {n}"
            )
        if self.max_batch_size <= 0:
            raise ConfigError(f"model {self.model_name!r}: max_batch_size must be > 0")
        if not (0.0 <= self.cache_size_percentage <= 1.0):
            raise ConfigError(
                f"model {self.model_name!r}: gpucacheper must be in [0, 1]"
            )
        if self.shard_strategy not in ("all_to_all", "psum"):
            raise ConfigError(
                f"model {self.model_name!r}: shard_strategy must be "
                f"'all_to_all' or 'psum', got {self.shard_strategy!r}"
            )
        if self.num_shards < 0:
            raise ConfigError(
                f"model {self.model_name!r}: num_shards must be >= 0"
            )
        if self.shard_tables:
            shards = self.num_shards or len(self.deployed_devices)
            if shards < 2:
                raise ConfigError(
                    f"model {self.model_name!r}: shard_tables needs >= 2 "
                    "shards (set num_shards or list >= 2 devices in "
                    "deployed_device_list)"
                )
            if self.num_shards and self.num_shards > len(self.deployed_devices):
                raise ConfigError(
                    f"model {self.model_name!r}: num_shards "
                    f"{self.num_shards} exceeds deployed_device_list size "
                    f"{len(self.deployed_devices)}"
                )
            if self.fp8_quant:
                raise ConfigError(
                    f"model {self.model_name!r}: shard_tables does not "
                    "support fp8_quant (use quant_bits 4/8/16/32)"
                )
            if not self.table_shard_axis:
                raise ConfigError(
                    f"model {self.model_name!r}: table_shard_axis must be "
                    "non-empty when shard_tables is set"
                )
            if self.embedding_cache_type != EmbeddingCacheType.STATIC:
                raise ConfigError(
                    f"model {self.model_name!r}: shard_tables serves the "
                    "full partitioned capacity (no per-device eviction); "
                    'set "embedding_cache_type": "static"'
                )
            if self.use_gpu_embedding_cache and self.cache_size_percentage < 1.0:
                raise ConfigError(
                    f"model {self.model_name!r}: shard_tables requires "
                    "gpucacheper 1.0 — sharding IS the capacity mechanism "
                    "(every row lives on some shard); a partial-residency "
                    "sharded cache would silently serve default rows for "
                    "the non-resident fraction (no tier miss-merge on the "
                    "collective path)"
                )

    @property
    def instance_devices(self) -> "list[int]":
        """Devices that get a serving instance (session + batcher).

        Unsharded models serve one replicated instance per entry of
        ``deployed_device_list`` (reference backend.cpp:418-425 instance
        routing). Sharded models span the WHOLE list with one mesh-wide
        instance — the list is the mesh, not a replica set."""
        if self.shard_tables:
            return [self.deployed_devices[0]]
        return self.deployed_devices

    @property
    def shard_devices(self) -> "list[int]":
        """The device ids forming the table-shard mesh (first ``num_shards``
        entries of deployed_device_list; the whole list when 0)."""
        n = self.num_shards or len(self.deployed_devices)
        return self.deployed_devices[:n]


@dataclasses.dataclass
class ParameterServerConfig:
    """The whole ps.json: storage tiers + update source + per-model params.

    Top-level layout mirrors reference backend.cpp:103-526: optional
    ``volatile_db``/``persistent_db``/``update_source`` blocks, a mandatory
    ``models`` array, and optional top-level ``supportlonglong``.
    """

    volatile_db: VolatileDatabaseParams = dataclasses.field(
        default_factory=VolatileDatabaseParams
    )
    persistent_db: PersistentDatabaseParams = dataclasses.field(
        default_factory=PersistentDatabaseParams
    )
    update_source: UpdateSourceParams = dataclasses.field(
        default_factory=UpdateSourceParams
    )
    models: dict[str, InferenceParams] = dataclasses.field(default_factory=dict)
    support_long_long: bool = True  # "supportlonglong"

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "ParameterServerConfig":
        cfg = cls()
        cfg.support_long_long = _get(
            obj, "supportlonglong", cfg.support_long_long, False, _as_bool
        )
        if "volatile_db" in obj:
            cfg.volatile_db = VolatileDatabaseParams.from_json(obj["volatile_db"])
        if "persistent_db" in obj:
            cfg.persistent_db = PersistentDatabaseParams.from_json(obj["persistent_db"])
        if "update_source" in obj:
            cfg.update_source = UpdateSourceParams.from_json(obj["update_source"])
        models = obj.get("models")
        if models is None:
            raise ConfigError("The parameter 'models' is mandatory and missing")
        for entry in models:
            params = InferenceParams.from_json(entry)
            cfg.models[params.model_name] = params
        return cfg

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "ParameterServerConfig":
        with open(path, "r") as f:
            return cls.from_json(json.load(f))

    @classmethod
    def create(cls, source) -> "ParameterServerConfig":
        """Accept a path, a JSON string, or an already-parsed mapping."""
        if isinstance(source, cls):
            return source
        if isinstance(source, Mapping):
            return cls.from_json(source)
        s = str(source)
        if s.lstrip().startswith("{"):
            return cls.from_json(json.loads(s))
        return cls.from_file(s)

    def model_params(self, model_name: str) -> InferenceParams:
        if model_name not in self.models:
            raise ConfigError(f"Model {model_name!r} not present in parameter server config")
        return self.models[model_name]
