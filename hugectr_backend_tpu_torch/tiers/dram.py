"""Host-DRAM tier: partitioned in-memory KV store for embedding vectors.

Port of the JAX package's tiers/dram.py numpy store. Partitioning by key low
bits mirrors the reference's Redis partitioning; overflow handling
(``overflow_margin`` / ``overflow_policy`` / ``overflow_resolution_target``)
evicts a partition that exceeds margin/num_partitions rows down to the
resolution target with the configured policy (random / least-used / oldest).

:func:`make_dram_tier` returns the native C++ store
(``native/kvstore.py NativeDramKVTier``, the same semantics) or the
shared-memory store, as the JAX package does; this numpy store is their plain
version, which the tests hold them against. The cluster tier is not ported
yet (ROADMAP queue A item 3): ``redis_cluster`` raises.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import (
    DatabaseOverflowPolicy,
    DatabaseType,
    VolatileDatabaseParams,
)
from hugectr_backend_tpu_torch.tiers.base import KVTier


class _Partition:
    """One partition: growable row arena + key->row dict + usage metadata."""

    __slots__ = ("dim", "kv", "vectors", "count", "last_used", "inserted_at", "tick")

    def __init__(self, dim: int, initial_capacity: int = 1024):
        self.dim = dim
        self.kv: dict[int, int] = {}
        self.vectors = np.empty((initial_capacity, dim), dtype=np.float32)
        self.count = 0
        self.last_used = np.zeros(initial_capacity, dtype=np.int64)
        self.inserted_at = np.zeros(initial_capacity, dtype=np.int64)
        self.tick = 0

    def _grow(self, need: int):
        cap = self.vectors.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        for name in ("vectors", "last_used", "inserted_at"):
            old = getattr(self, name)
            shape = (new_cap,) + old.shape[1:]
            new = np.empty(shape, dtype=old.dtype)
            new[: self.count] = old[: self.count]
            setattr(self, name, new)


class DramKVTier(KVTier):
    """Partitioned, thread-safe (per-partition locks) DRAM store."""

    def __init__(self, params: Optional[VolatileDatabaseParams] = None):
        self.params = params or VolatileDatabaseParams()
        self.num_partitions = self.params.effective_num_partitions()
        self._tables: dict[str, list[_Partition]] = {}
        self._dims: dict[str, int] = {}
        self._locks: dict[str, list[threading.Lock]] = {}
        self._meta_lock = threading.Lock()

    # -- table lifecycle ----------------------------------------------------

    def create_table(self, tag: str, dim: int) -> None:
        with self._meta_lock:
            if tag in self._tables:
                if self._dims[tag] != dim:
                    raise ValueError(
                        f"table {tag} exists with dim {self._dims[tag]}, requested {dim}"
                    )
                return
            self._tables[tag] = [_Partition(dim) for _ in range(self.num_partitions)]
            self._locks[tag] = [threading.Lock() for _ in range(self.num_partitions)]
            self._dims[tag] = dim

    def drop_table(self, tag: str) -> None:
        with self._meta_lock:
            self._tables.pop(tag, None)
            self._locks.pop(tag, None)
            self._dims.pop(tag, None)

    def tables(self) -> list[str]:
        return list(self._tables.keys())

    def dim(self, tag: str) -> int:
        return self._dims[tag]

    # -- bulk ops ------------------------------------------------------------

    def _partition_of(self, keys: np.ndarray) -> np.ndarray:
        return (keys & np.int64(0x7FFFFFFF)) % self.num_partitions

    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        vectors = np.asarray(vectors, dtype=np.float32).reshape(keys.shape[0], -1)
        if tag not in self._tables:
            self.create_table(tag, int(vectors.shape[1]))
        parts = self._tables[tag]
        locks = self._locks[tag]
        pidx = self._partition_of(keys)
        written = 0
        for p in np.unique(pidx):
            sel = pidx == p
            written += self._insert_partition(parts[p], locks[p], keys[sel], vectors[sel])
        return written

    def _insert_partition(self, part: _Partition, lock, keys, vectors) -> int:
        # Dedup within the batch (LAST occurrence wins): a twice-new key must
        # not get two arena rows under one kv entry.
        if len(keys) > 1:
            _, first = np.unique(keys[::-1], return_index=True)
            if first.size != len(keys):
                sel = len(keys) - 1 - first
                keys, vectors = keys[sel], vectors[sel]
        with lock:
            part.tick += 1
            tick = part.tick
            rows = np.fromiter(
                (part.kv.get(int(k), -1) for k in keys), dtype=np.int64, count=len(keys)
            )
            new_mask = rows < 0
            n_new = int(new_mask.sum())
            if n_new < len(keys):
                old_rows = rows[~new_mask]
                part.vectors[old_rows] = vectors[~new_mask]
                part.last_used[old_rows] = tick
            if n_new:
                part._grow(part.count + n_new)
                start = part.count
                new_rows = np.arange(start, start + n_new)
                part.vectors[new_rows] = vectors[new_mask]
                part.last_used[new_rows] = tick
                part.inserted_at[new_rows] = tick
                for k, r in zip(keys[new_mask], new_rows):
                    part.kv[int(k)] = int(r)
                part.count += n_new
            self._maybe_evict(part)
            return len(keys)

    def _maybe_evict(self, part: _Partition):
        margin = self.params.overflow_margin
        per_part = max(margin // self.num_partitions, 1) if margin < 2**62 else None
        if per_part is None or part.count <= per_part:
            return
        target = int(per_part * self.params.overflow_resolution_target)
        n_evict = part.count - target
        if n_evict <= 0:
            return
        policy = self.params.overflow_policy
        if n_evict >= part.count:
            victims = np.arange(part.count)
        elif policy == DatabaseOverflowPolicy.EVICT_RANDOM:
            victims = np.random.default_rng(part.tick).choice(
                part.count, size=n_evict, replace=False
            )
        elif policy == DatabaseOverflowPolicy.EVICT_LEAST_USED:
            victims = np.argpartition(part.last_used[: part.count], n_evict)[:n_evict]
        else:  # EVICT_OLDEST
            victims = np.argpartition(part.inserted_at[: part.count], n_evict)[:n_evict]
        self._evict_rows(part, victims)

    def _evict_rows(self, part: _Partition, victim_rows: np.ndarray):
        # Compact: move tail rows into victim holes, fix the dict.
        victim_rows = np.unique(victim_rows)
        row_to_key = {r: k for k, r in part.kv.items()}
        for r in victim_rows:
            del part.kv[row_to_key[int(r)]]
        keep = np.ones(part.count, dtype=bool)
        keep[victim_rows] = False
        new_count = int(keep.sum())
        remap_rows = np.flatnonzero(keep)
        part.vectors[:new_count] = part.vectors[remap_rows]
        part.last_used[:new_count] = part.last_used[remap_rows]
        part.inserted_at[:new_count] = part.inserted_at[remap_rows]
        for new_r, old_r in enumerate(remap_rows):
            if old_r != new_r:
                k = row_to_key.get(int(old_r))
                if k is not None:
                    part.kv[k] = new_r
        part.count = new_count

    def query(self, tag: str, keys: np.ndarray):
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        dim = self._dims[tag]
        out = np.zeros((keys.shape[0], dim), dtype=np.float32)
        found = np.zeros(keys.shape[0], dtype=bool)
        parts = self._tables[tag]
        locks = self._locks[tag]
        pidx = self._partition_of(keys)
        for p in np.unique(pidx):
            sel = np.flatnonzero(pidx == p)
            part = parts[p]
            with locks[p]:
                part.tick += 1
                rows = np.fromiter(
                    (part.kv.get(int(k), -1) for k in keys[sel]),
                    dtype=np.int64,
                    count=len(sel),
                )
                hit = rows >= 0
                hit_rows = rows[hit]
                out[sel[hit]] = part.vectors[hit_rows]
                part.last_used[hit_rows] = part.tick
                found[sel[hit]] = True
        return out, found

    def evict(self, tag: str, keys: np.ndarray) -> int:
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        parts = self._tables[tag]
        locks = self._locks[tag]
        pidx = self._partition_of(keys)
        n = 0
        for p in np.unique(pidx):
            sel = pidx == p
            part = parts[p]
            with locks[p]:
                rows = [part.kv[int(k)] for k in keys[sel] if int(k) in part.kv]
                if rows:
                    self._evict_rows(part, np.asarray(rows))
                    n += len(rows)
        return n

    def size(self, tag: str) -> int:
        return sum(p.count for p in self._tables[tag])

    def keys(self, tag: str) -> np.ndarray:
        chunks = []
        for p, lock in zip(self._tables[tag], self._locks[tag]):
            with lock:  # a concurrent insert/evict mutates kv mid-iteration
                chunks.append(
                    np.fromiter(p.kv.keys(), dtype=np.int64, count=len(p.kv))
                )
        return np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)


def make_dram_tier(params: Optional[VolatileDatabaseParams] = None) -> KVTier:
    """The volatile-db tier for ``params.type``.

    ``hash_map`` / ``parallel_hash_map`` (and ``disabled``, which the JAX
    package also serves from the local store) get the native
    :class:`~hugectr_backend_tpu_torch.native.kvstore.NativeDramKVTier`;
    ``multi_process_hash_map`` the /dev/shm store shared by every serving
    process on the host (reference docs/hierarchical_parameter_server.md:
    417-421). The cluster store is queued."""
    from hugectr_backend_tpu_torch.native.kvstore import (
        NativeDramKVTier,
        SharedMemoryDramKVTier,
    )

    if params is not None and params.type == DatabaseType.MULTI_PROCESS_HASH_MAP:
        return SharedMemoryDramKVTier(params)
    if params is not None and params.type == DatabaseType.REDIS_CLUSTER:
        raise NotImplementedError(
            "volatile_db type redis_cluster needs the cluster tier "
            "(ROADMAP queue A item 3, dynamic/UVM caches and the SSD, "
            "cluster and shm tiers)"
        )
    return NativeDramKVTier(params)
