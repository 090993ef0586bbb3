"""Hierarchical parameter server: table manager over the device and DRAM tiers.

Port of the JAX package's ps/parameter_server.py (the reference engine's
``HierParameterServerBase`` contract):

    create(ps_json, device=None)           -> loads all models' sparse files
    get_model_params(model)                -> InferenceParams
    update_database_per_model(params)      -> (re)load a model's tables
    create_embedding_cache_per_model(name) -> allocate + warm device caches
    get_embedding_cache(model, device)     -> EmbeddingCache

Caches live on ``cuda:<deployed_device_list[i]>`` unless ``create`` is given
``device="cpu"``. A ps.json option that this port does not cover yet raises
``NotImplementedError`` naming its ROADMAP item; none is ignored.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache
from hugectr_backend_tpu_torch.config.params import (
    ConfigError,
    DatabaseType,
    EmbeddingCacheType,
    InferenceParams,
    ParameterServerConfig,
    UpdateSourceType,
)
from hugectr_backend_tpu_torch.io.sparse_model import read_sparse_model
from hugectr_backend_tpu_torch.serving import metrics
from hugectr_backend_tpu_torch.tiers.base import KVTier, table_tag
from hugectr_backend_tpu_torch.tiers.dram import make_dram_tier
from hugectr_backend_tpu_torch.tiers.hbm import build_arena_views, default_device
from hugectr_backend_tpu_torch.utils.logging import get_logger


def arena_member_max_rows() -> int:
    """Tables with at most this many resident rows join a shared per-dim
    "arena" group (device scales); larger tables go "solo" (host-gathered
    scales). Same variable and default as the JAX package."""
    return int(os.environ.get("HPS_TPU_ARENA_MEMBER_MAX_ROWS", 1 << 16))


def onehot_member_max_rows() -> int:
    """Tables with at most this many rows (incl. the default row) form the
    "onehot" group, which the fused DLRM server folds into the interaction
    kernel. Same variable and default as the JAX package."""
    return int(os.environ.get("HPS_TPU_ONEHOT_MAX_ROWS", 1 << 12))


log = get_logger("hps_tpu.ps")


def _check_supported(config: ParameterServerConfig) -> None:
    """Refuse the ps.json options that this port does not cover yet."""
    if config.persistent_db.type != DatabaseType.DISABLED:
        raise NotImplementedError(
            "persistent_db (the SSD tier) is ROADMAP queue A item 3")
    if config.update_source.type != UpdateSourceType.NONE:
        raise NotImplementedError(
            "update_source (the online update path) is ROADMAP queue A item 3")
    for p in config.models.values():
        if p.embedding_cache_type != EmbeddingCacheType.STATIC:
            raise NotImplementedError(
                f"model {p.model_name!r}: embedding_cache_type "
                f"{p.embedding_cache_type.value!r}: the dynamic, stochastic and "
                "UVM caches are ROADMAP queue A item 3 (use \"static\")")
        if p.shard_tables:
            raise NotImplementedError(
                f"model {p.model_name!r}: shard_tables is ROADMAP queue A "
                "item 7 (parallel/ on torch.distributed)")
        if p.use_cuda_graph:
            log.info("model %s: use_cuda_graph: lookups run eagerly until "
                     "ROADMAP queue A item 2 (CUDA graphs per bucket)",
                     p.model_name)


class HierParameterServer:
    """Single shared parameter server for all models of a process."""

    def __init__(self, config: ParameterServerConfig, device=None):
        _check_supported(config)
        self.config = config
        # "cpu" -> everything on the CPU; otherwise cuda:<deployed id> per
        # cache (default_device raises here when there is no card).
        self.on_cpu = default_device(device).type == "cpu"
        self.dram: KVTier = make_dram_tier(config.volatile_db)
        # caches[model_name][device_id] -> EmbeddingCache
        self._caches: dict[str, dict[int, EmbeddingCache]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ create

    @classmethod
    def create(cls, source, device=None) -> "HierParameterServer":
        """Load every model's sparse files into the DRAM tier and build the
        device caches. ``device``: None puts each cache on
        ``cuda:<deployed_device_list[i]>`` (and raises when there is no card);
        ``"cpu"`` runs everything on the CPU."""
        config = ParameterServerConfig.create(source)
        ps = cls(config, device=device)
        if config.volatile_db.initialize_after_startup:
            for params in config.models.values():
                ps.update_database_per_model(params)
                if params.init_ec:
                    ps.create_embedding_cache_per_model(params.model_name)
        else:
            # Resume path: skip the sparse-file load; caches warm from the
            # (empty) tiers.
            for params in config.models.values():
                for t in range(params.num_tables):
                    tag = table_tag(params.model_name, params.table_name(t))
                    ps.dram.create_table(tag, params.embedding_vecsize_per_table[t])
                if params.init_ec:
                    ps.create_embedding_cache_per_model(params.model_name)
        return ps

    # ---------------------------------------------------- reference contract

    def get_model_params(self, model_name: str) -> InferenceParams:
        return self.config.model_params(model_name)

    def update_database_per_model(self, params: InferenceParams) -> None:
        """Load (or re-load) a model's sparse files into the DRAM tier."""
        self.config.models[params.model_name] = params
        init_rate = self.config.volatile_db.initial_cache_rate
        for t, path in enumerate(params.sparse_files):
            tag = table_tag(params.model_name, params.table_name(t))
            dim = params.embedding_vecsize_per_table[t]
            tbl = read_sparse_model(path, embedding_dim=dim)
            self.dram.create_table(tag, dim)
            # Version re-load: evict tier keys the NEW version dropped.
            stale = np.setdiff1d(self._tier_keys(tag), tbl.keys, assume_unique=False)
            if stale.size:
                self.dram.evict(tag, stale)
                log.info("evicted %d stale rows from %s on re-load", stale.size, tag)
            n_dram = int(tbl.num_rows * min(max(init_rate, 0.0), 1.0))
            if n_dram > 0:
                self.dram.insert(tag, tbl.keys[:n_dram], tbl.vectors[:n_dram])
            log.info("loaded table %s: %d rows x %d dim (%d rows -> DRAM)",
                     tag, tbl.num_rows, dim, n_dram)

    def create_embedding_cache_per_model(self, model_name: str) -> None:
        """Allocate the per-device caches and warm ``gpucacheper`` of each
        table."""
        params = self.get_model_params(model_name)
        with self._lock:
            host_tables = self._prep_model_tables(params)
            per_device: dict[int, EmbeddingCache] = {}
            for dev_id in params.deployed_devices:
                if self.on_cpu:
                    device = torch.device("cpu")
                else:
                    if dev_id >= torch.cuda.device_count():
                        raise ConfigError(
                            f"deployed_device_list entry {dev_id} out of range; "
                            f"{torch.cuda.device_count()} devices visible")
                    device = torch.device("cuda", dev_id)
                per_device[dev_id] = self._build_cache(params, device, host_tables)
            self._caches[model_name] = per_device

    def _quant_mode(self, params: InferenceParams) -> str:
        if not params.use_gpu_embedding_cache:
            # Cache off -> serve full precision from the device anyway.
            return "fp32"
        if params.fp8_quant:
            return "fp8"
        return {4: "int4", 8: "int8", 16: "bf16", 32: "fp32"}.get(params.quant_bits, "int8")

    def _prep_model_tables(self, params: InferenceParams):
        """Device-independent host prep for one model's tables: the tier
        fetch of the resident rows (static cache: the first ``gpucacheper``
        of the sorted keys)."""

        def prep_table(t: int):
            tag = table_tag(params.model_name, params.table_name(t))
            all_keys = self._tier_keys(tag)
            frac = params.cache_size_percentage if params.use_gpu_embedding_cache else 1.0
            frac = min(max(frac, 0.0), 1.0)
            n_resident = (all_keys.shape[0] if frac >= 1.0
                          else int(np.ceil(all_keys.shape[0] * frac)))
            resident_keys = all_keys[:n_resident]
            dim = params.embedding_vecsize_per_table[t]
            if n_resident > 0:
                vecs, found = self._query_tiers(tag, resident_keys)
                if not found.all():
                    resident_keys = resident_keys[found]
                    vecs = vecs[found]
            else:
                vecs = np.zeros((0, dim), np.float32)
            return resident_keys, vecs

        with ThreadPoolExecutor(
            max_workers=min(max(params.num_of_worker_buffer_in_pool, 1), 8)
        ) as ex:
            return list(ex.map(prep_table, range(params.num_tables)))

    def _build_cache(self, params: InferenceParams, device,
                     host_tables) -> EmbeddingCache:
        quant = self._quant_mode(params)
        defaults = [params.default_value_for_table(t) for t in range(params.num_tables)]
        # Grouping policy of the JAX package: tiny tables -> per-dim
        # "onehot" arena, small tables -> per-dim "arena", huge -> "solo".
        tables: list = [None] * params.num_tables
        groups: dict = {}
        for t, d in enumerate(params.embedding_vecsize_per_table):
            n_res = host_tables[t][0].shape[0]
            # int4 never takes the one-hot kind (packed nibbles).
            if n_res + 1 <= onehot_member_max_rows() and quant != "int4":
                groups.setdefault(("onehot", d), []).append(t)
            elif n_res <= arena_member_max_rows():
                groups.setdefault(("arena", d), []).append(t)
            else:
                groups.setdefault(("solo", t), []).append(t)
        for (gkind, _), members in groups.items():
            views = build_arena_views(
                [host_tables[t] for t in members],
                quant=quant,
                default_values=[defaults[t] for t in members],
                device=device,
                lookup_kind=gkind,
            )
            for t, v in zip(members, views):
                tables[t] = v
        tier_query = lambda ti, keys, m=params.model_name, p=params: self._query_tiers(  # noqa: E731
            table_tag(m, p.table_name(ti)), keys)
        return EmbeddingCache(params, tables, device=device, tier_query=tier_query)

    def _tier_keys(self, tag: str) -> np.ndarray:
        keys = self.dram.keys(tag) if tag in self.dram.tables() else np.empty(0, np.int64)
        return np.sort(keys)

    def _query_tiers(self, tag: str, keys: np.ndarray):
        vecs, found = self.dram.query(tag, keys)
        n_hit = int(found.sum())
        metrics.TIER_HIT.inc(n_hit, tier="dram")
        metrics.TIER_MISS.inc(keys.shape[0] - n_hit, tier="dram")
        return vecs, found

    def get_embedding_cache(self, model_name: str, device_id: int) -> EmbeddingCache:
        try:
            return self._caches[model_name][device_id]
        except KeyError:
            raise KeyError(
                f"no embedding cache for model {model_name!r} on device {device_id}; "
                "call create_embedding_cache_per_model first"
            ) from None
