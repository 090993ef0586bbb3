"""Hierarchical parameter server: table manager over the device, DRAM and SSD tiers.

Port of the JAX package's ps/parameter_server.py (the reference engine's
``HierParameterServerBase`` contract):

    create(ps_json, device=None)           -> loads all models' sparse files
    get_model_params(model)                -> InferenceParams
    update_database_per_model(params)      -> (re)load a model's tables
    create_embedding_cache_per_model(name) -> allocate + warm device caches
    get_embedding_cache(model, device)     -> EmbeddingCache
    destroy_embedding_cache_per_model(name), refresh_embedding_cache(name, dev),
    get_model_version / update_model_version, shutdown
    apply_updates(model, table, keys, vectors), prefetch(model, table, keys)

The volatile DB (hash maps) is the host-DRAM tier, the persistent DB
(``rocks_db``) the local-SSD tier (tiers/ssd.py), the GPU cache the device
``EmbeddingCache`` of the configured flavour. An ``update_source`` (file
queue or Kafka) streams trainer updates into the DRAM and SSD tiers; the
device caches pick them up on refresh.

Caches live on ``cuda:<deployed_device_list[i]>`` unless ``create`` is given
a device: ``"cpu"`` puts every id on the host, ``"cuda:<i>"`` every id on
that card (a ``shard_tables`` model's shards too: several shards on one
device, the counterpart of the JAX tests' virtual devices). A
``shard_tables`` model gets ONE mesh-wide ``ShardedEmbeddingCache``
(parallel/sharded_cache.py) under ``instance_devices[0]``. The port covers
every ps.json option; ``use_cuda_graph`` is logged, lookups run eagerly
(ROADMAP queue A item 2).
"""

from __future__ import annotations

import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import (
    DynamicEmbeddingCache,
    EmbeddingCache,
    UvmEmbeddingCache,
)
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
from hugectr_backend_tpu_torch.tiers.ssd import SsdKVTier
from hugectr_backend_tpu_torch.update.source import UpdateConsumer, make_update_source
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
    """Log the ps.json options the port takes without acting on them."""
    for p in config.models.values():
        if p.use_cuda_graph:
            log.info("model %s: use_cuda_graph: lookups run eagerly until "
                     "ROADMAP queue A item 2 (CUDA graphs per bucket)",
                     p.model_name)


class HierParameterServer:
    """Single shared parameter server for all models of a process."""

    def __init__(self, config: ParameterServerConfig, device=None):
        _check_supported(config)
        self.config = config
        # None -> cuda:<deployed id> per cache; "cpu" or "cuda:<i>" -> every
        # id on that device (default_device raises here when there is no
        # card).
        dev = default_device(device)
        pinned = device is not None and (dev.type == "cpu" or torch.device(device).index is not None)
        self._pinned = dev if pinned else None
        self.dram: KVTier = make_dram_tier(config.volatile_db)
        self.ssd: Optional[KVTier] = None
        if config.persistent_db.type == DatabaseType.ROCKS_DB:
            self.ssd = SsdKVTier(config.persistent_db)
        # Async tier promotion: SSD-hit write-backs into DRAM and explicit
        # prefetches run off the request thread.
        self._prefetch_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="hps-prefetch")
        # caches[model_name][device_id] -> EmbeddingCache
        self._caches: dict[str, dict[int, EmbeddingCache]] = {}
        # Authoritative row count per table (from the last sparse-file
        # load): a dynamic cache's capacity is gpucacheper x THIS, not x the
        # rows tier-resident at build time.
        self._table_rows: dict[str, int] = {}
        self._model_versions: dict[str, int] = {}
        self._lock = threading.Lock()
        # Streaming update ingestion (reference Kafka consumer,
        # README.md:213-218); started last, once the tiers exist.
        self.update_consumer: Optional[UpdateConsumer] = None
        if config.update_source.type != UpdateSourceType.NONE:
            self.update_consumer = UpdateConsumer(
                make_update_source(config.update_source),
                self._apply_update_by_tag, config.update_source).start()

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
            # Resume path: skip the sparse-file load and reconnect to the
            # persistent tier (the SSD store is durable across restarts);
            # caches warm from the tiers.
            for params in config.models.values():
                for t in range(params.num_tables):
                    tag = table_tag(params.model_name, params.table_name(t))
                    dim = params.embedding_vecsize_per_table[t]
                    ps.dram.create_table(tag, dim)
                    if ps.ssd is not None:
                        ps.ssd.create_table(tag, dim)
                if params.init_ec:
                    ps.create_embedding_cache_per_model(params.model_name)
        return ps

    # ---------------------------------------------------- reference contract

    def get_hps_model_configuration_map(self) -> dict[str, InferenceParams]:
        return dict(self.config.models)

    def get_model_params(self, model_name: str) -> InferenceParams:
        return self.config.model_params(model_name)

    def update_database_per_model(self, params: InferenceParams) -> None:
        """Load (or re-load) a model's sparse files into the DRAM and SSD
        tiers (reference model_state.cpp:132,389)."""
        self.config.models[params.model_name] = params
        init_rate = self.config.volatile_db.initial_cache_rate
        # UVM: the FULL table is pinned in host DRAM whatever
        # initial_cache_rate says (misses never fall to the SSD).
        if params.embedding_cache_type == EmbeddingCacheType.UVM:
            init_rate = 1.0
        for t, path in enumerate(params.sparse_files):
            tag = table_tag(params.model_name, params.table_name(t))
            dim = params.embedding_vecsize_per_table[t]
            tbl = read_sparse_model(path, embedding_dim=dim)
            self._table_rows[tag] = int(tbl.num_rows)
            self.dram.create_table(tag, dim)
            # Version re-load: evict tier keys the NEW version dropped.
            stale = np.setdiff1d(self._tier_keys(tag), tbl.keys, assume_unique=False)
            if stale.size:
                self.dram.evict(tag, stale)
                if self.ssd is not None:
                    self.ssd.evict(tag, stale)
                log.info("evicted %d stale rows from %s on re-load", stale.size, tag)
            n_dram = int(tbl.num_rows * min(max(init_rate, 0.0), 1.0))
            # Version re-load: DRAM rows promoted while the OLD version
            # served (cache_missed_embeddings write-backs) may lie outside
            # the insert window below; overwrite them with the NEW version.
            resident = self.dram.keys(tag)
            if resident.size:
                retained = np.intersect1d(resident, tbl.keys)
                extra = np.setdiff1d(retained, tbl.keys[:n_dram])
                if extra.size:
                    order = np.argsort(tbl.keys, kind="stable")
                    idx = order[np.searchsorted(tbl.keys[order], extra)]
                    self.dram.insert(tag, extra, tbl.vectors[idx])
                    log.info("refreshed %d promoted DRAM rows of %s to the new "
                             "version", extra.size, tag)
            if n_dram > 0:
                self.dram.insert(tag, tbl.keys[:n_dram], tbl.vectors[:n_dram])
            if self.ssd is not None:
                self.ssd.create_table(tag, dim)
                self.ssd.insert(tag, tbl.keys, tbl.vectors)
            log.info("loaded table %s: %d rows x %d dim (%d rows -> DRAM%s)",
                     tag, tbl.num_rows, dim, n_dram,
                     ", all -> SSD" if self.ssd is not None else "")

    def create_embedding_cache_per_model(self, model_name: str) -> None:
        """Allocate the per-device caches and warm ``gpucacheper`` of each
        table."""
        params = self.get_model_params(model_name)
        with self._lock:
            host_tables = self._prep_model_tables(params)
            per_device: dict[int, EmbeddingCache] = {}
            if params.shard_tables:
                # Capacity partitioning by config (the reference's
                # num_partitions): ONE mesh-wide sharded cache spanning
                # deployed_device_list, served by a single instance.
                per_device[params.instance_devices[0]] = self._build_sharded_cache(
                    params, host_tables)
            for dev_id in ([] if params.shard_tables else params.deployed_devices):
                if self._pinned is not None:
                    device = self._pinned
                else:
                    if dev_id >= torch.cuda.device_count():
                        raise ConfigError(
                            f"deployed_device_list entry {dev_id} out of range; "
                            f"{torch.cuda.device_count()} devices visible")
                    device = torch.device("cuda", dev_id)
                per_device[dev_id] = self._build_cache(params, device, host_tables)
            self._caches[model_name] = per_device
            self._model_versions.setdefault(model_name, 1)

    def _build_sharded_cache(self, params: InferenceParams, host_tables):
        """Row-shard every table over the mesh of the model's
        deployed_device_list (parallel/sharded_cache.py)."""
        from hugectr_backend_tpu_torch.parallel.sharded_cache import (
            ShardedEmbeddingCache,
            build_shard_mesh,
        )
        from hugectr_backend_tpu_torch.parallel.sharded_table import ShardedTable

        quant = self._quant_mode(params)
        mesh = build_shard_mesh(params, self._pinned)
        tables = []
        for t, (keys, vecs) in enumerate(host_tables):
            try:
                tables.append(ShardedTable.from_numpy(
                    keys, vecs, mesh, quant=quant,
                    default_value=params.default_value_for_table(t)))
            except NotImplementedError as e:
                raise ConfigError(f"model {params.model_name!r} table {t}: {e}") from None
        tier_query = lambda ti, keys, m=params.model_name, p=params: self._query_tiers(  # noqa: E731
            table_tag(m, p.table_name(ti)), keys)
        tier_keys = lambda ti, m=params.model_name, p=params: self._tier_keys(  # noqa: E731
            table_tag(m, p.table_name(ti)))
        log.info(
            "sharded model %s: %d tables over %d-device mesh (axis %r, %s, %s), "
            "%.1f MB/shard", params.model_name, len(tables),
            mesh.shape[params.table_shard_axis], params.table_shard_axis,
            params.shard_strategy, quant, sum(t.nbytes_per_shard() for t in tables) / 1e6)
        return ShardedEmbeddingCache(params, tables, mesh, tier_query=tier_query,
                                     tier_keys=tier_keys)

    def _quant_mode(self, params: InferenceParams) -> str:
        if not params.use_gpu_embedding_cache:
            # Cache off -> serve full precision from the device anyway.
            return "fp32"
        if params.fp8_quant:
            return "fp8"
        return {4: "int4", 8: "int8", 16: "bf16", 32: "fp32"}.get(params.quant_bits, "int8")

    #: Key base of a dynamic cache's capacity-reserve sentinels: far outside
    #: any trainer's id space (the SlotMap's empty key is INT64_MIN).
    _RESERVE_KEY_BASE = np.iinfo(np.int64).min + 16

    def _prep_model_tables(self, params: InferenceParams):
        """Device-independent host prep for one model's tables: the tier
        fetch of the resident rows (the first ``gpucacheper`` of the sorted
        keys) and a dynamic cache's capacity reserve."""

        def prep_table(t: int):
            tag = table_tag(params.model_name, params.table_name(t))
            all_keys = self._tier_keys(tag)
            frac = params.cache_size_percentage if params.use_gpu_embedding_cache else 1.0
            frac = min(max(frac, 0.0), 1.0)
            if params.embedding_cache_type == EmbeddingCacheType.STATIC and frac >= 1.0:
                n_resident = all_keys.shape[0]
            else:
                n_resident = int(np.ceil(all_keys.shape[0] * frac))
            resident_keys = all_keys[:n_resident]
            dim = params.embedding_vecsize_per_table[t]
            if n_resident > 0:
                vecs, found = self._query_tiers(tag, resident_keys)
                if not found.all():
                    resident_keys = resident_keys[found]
                    vecs = vecs[found]
            else:
                vecs = np.zeros((0, dim), np.float32)
            if (params.embedding_cache_type != EmbeddingCacheType.STATIC
                    and params.use_gpu_embedding_cache):
                # Dynamic / stochastic / UVM capacity: gpucacheper x TABLE
                # rows. Capacity the tiers cannot fill yet is reserved with
                # sentinel-keyed default rows: sorted first, they sit at the
                # slot map's LRU cold end and are evicted before any real key.
                total_rows = max(self._table_rows.get(tag, 0), all_keys.shape[0])
                cap = max(int(np.ceil(total_rows * frac)), resident_keys.shape[0], 1)
                pad = cap - resident_keys.shape[0]
                if pad > 0:
                    sentinels = self._RESERVE_KEY_BASE + np.arange(pad, dtype=np.int64)
                    resident_keys = np.concatenate([resident_keys, sentinels])
                    vecs = np.concatenate([
                        vecs, np.full((pad, dim), params.default_value_for_table(t),
                                      np.float32)])
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
        cls = {EmbeddingCacheType.STATIC: EmbeddingCache,
               EmbeddingCacheType.UVM: UvmEmbeddingCache}.get(
                   params.embedding_cache_type, DynamicEmbeddingCache)
        return cls(params, tables, device=device, tier_query=tier_query)

    def _tier_keys(self, tag: str) -> np.ndarray:
        keys = self.dram.keys(tag) if tag in self.dram.tables() else np.empty(0, np.int64)
        if self.ssd is not None and tag in self.ssd.tables():
            keys = np.union1d(keys, self.ssd.keys(tag))
        return np.sort(keys)

    def _query_tiers(self, tag: str, keys: np.ndarray):
        """Cascade DRAM -> SSD (reference VDB -> PDB fallback,
        docs/hierarchical_parameter_server.md:40-43)."""
        vecs, found = self.dram.query(tag, keys)
        n_hit = int(found.sum())
        metrics.TIER_HIT.inc(n_hit, tier="dram")
        metrics.TIER_MISS.inc(keys.shape[0] - n_hit, tier="dram")
        if self.ssd is not None and not found.all():
            missing = np.flatnonzero(~found)
            v2, f2 = self.ssd.query(tag, keys[missing])
            n_ssd_hit = int(f2.sum())
            metrics.TIER_HIT.inc(n_ssd_hit, tier="ssd")
            metrics.TIER_MISS.inc(missing.size - n_ssd_hit, tier="ssd")
            hit2 = missing[f2]
            vecs[hit2] = v2[f2]
            found[hit2] = True
            if self.config.volatile_db.cache_missed_embeddings and hit2.size:
                # Write SSD hits back into DRAM (doc:488-512), off the
                # request thread: the requester already has its rows.
                self._prefetch_pool.submit(
                    self.dram.insert, tag, keys[hit2].copy(), vecs[hit2].copy())
        return vecs, found

    def prefetch(self, model_name: str, table_idx: int, keys: np.ndarray) -> None:
        """Asynchronously promote ``keys`` from the SSD tier into DRAM (warm
        the DRAM tier ahead of expected traffic, off the request path)."""
        if self.ssd is None:
            return
        params = self.get_model_params(model_name)
        tag = table_tag(model_name, params.table_name(table_idx))
        keys = np.asarray(keys, np.int64).copy()

        def _promote():
            _, have = self.dram.query(tag, keys)
            want = keys[~have]
            if want.size == 0:
                return
            vecs, found = self.ssd.query(tag, want)
            if found.any():
                self.dram.insert(tag, want[found], vecs[found])

        self._prefetch_pool.submit(_promote)

    def get_embedding_cache(self, model_name: str, device_id: int) -> EmbeddingCache:
        try:
            return self._caches[model_name][device_id]
        except KeyError:
            raise KeyError(
                f"no embedding cache for model {model_name!r} on device {device_id}; "
                "call create_embedding_cache_per_model first"
            ) from None

    def destroy_embedding_cache_per_model(self, model_name: str) -> None:
        """Drop a model's caches and stop their worker threads (reference
        model_state.cpp:111, there spelled ``destory_...``)."""
        with self._lock:
            per_device = self._caches.pop(model_name, None)
        for cache in (per_device or {}).values():
            cache.shutdown()

    # The reference API's spelling, kept as an alias.
    destory_embedding_cache_per_model = destroy_embedding_cache_per_model

    def refresh_embedding_cache(self, model_name: str, device_id: int) -> int:
        """Re-pull one device cache's resident rows from the DRAM tier
        (reference model_state.cpp:135,160). -> rows refreshed."""
        return self.get_embedding_cache(model_name, device_id).refresh()

    # ------------------------------------------------------------- versioning

    def get_model_version(self, model_name: str) -> int:
        """Reference backend.cpp:83-90; 0 for a model never deployed."""
        return self._model_versions.get(model_name, 0)

    def update_model_version(self, model_name: str, version: int) -> None:
        """Reference backend.cpp:94-99."""
        with self._lock:
            self._model_versions[model_name] = version

    # ------------------------------------------------------------- update path

    def _apply_update_by_tag(self, tag: str, keys: np.ndarray, vectors: np.ndarray):
        """Route one streamed update batch into the tiers whose
        ``update_filters`` regexes match the table tag."""
        if any(re.match(f, tag) for f in self.config.volatile_db.update_filters):
            if tag not in self.dram.tables():
                self.dram.create_table(tag, int(np.asarray(vectors).shape[-1]))
            self.dram.insert(tag, keys, vectors)
        if self.ssd is not None and any(
                re.match(f, tag) for f in self.config.persistent_db.update_filters):
            self.ssd.insert(tag, keys, vectors)

    def apply_updates(self, model_name: str, table_idx: int,
                      keys: np.ndarray, vectors: np.ndarray) -> None:
        """Write parameter updates into the DRAM and SSD tiers (the
        reference's Kafka-consumer write path, README.md:213-218). The device
        caches pick the new values up on their next refresh."""
        params = self.get_model_params(model_name)
        tag = table_tag(model_name, params.table_name(table_idx))
        self.dram.insert(tag, keys, vectors)
        if self.ssd is not None:
            self.ssd.insert(tag, keys, vectors)

    def shutdown(self) -> None:
        """Stop the update consumer, the prefetch pool, the SSD tier's
        compactor and every cache's worker threads (the tiers and caches stay
        usable for lookups)."""
        if self.update_consumer is not None:
            self.update_consumer.stop()
        self._prefetch_pool.shutdown(wait=False)
        if self.ssd is not None:
            self.ssd.close()
        with self._lock:
            caches = [c for per in self._caches.values() for c in per.values()]
        for cache in caches:
            cache.shutdown()
