"""Device embedding cache: per-model, per-device hot-row store.

Port of the JAX package's cache/embedding_cache.py. Lookups are translate
(host) -> gather + dequant (device, K1) -> miss merge (rows that the device
tier does not hold come from the DRAM / SSD tiers and are scattered into the
result). The flavours differ in their online-insert policy:

- STATIC (``EmbeddingCache``): the resident set is fixed at creation.
- DYNAMIC (``DynamicEmbeddingCache``): misses fetched from the tiers are
  inserted, synchronously while the table's hit rate is below
  ``hit_rate_threshold`` and by a bounded background drainer above it; the
  least-recently-used resident is evicted (a host ``SlotMap`` owns the key
  -> slot index; device rows stay at their slots).
- STOCHASTIC: as DYNAMIC, but each missed key is inserted with probability
  1/2 (the same ``np.random.default_rng(0)`` stream as the JAX package).
- UVM (``UvmEmbeddingCache``): misses are counted, not inserted;
  ``refresh`` admits the hottest missed keys, then refreshes the resident
  window.

Invariants kept from the JAX package:
- translation and the operand snapshot happen under ONE hold of ``_lock``;
- tables are functional: writers replace a tensor (``scatter_rows`` copies),
  never write into one a reader holds, so a lookup reads the rows of the
  moment it translated even if an insert evicts its slots right after;
- padding and misses map to the default row (slot == capacity).

Every thread that writes rows (the drainer, the refresher pool) runs on the
device's default stream, as the lookups do: writes and reads stay ordered.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.cache.slotmap import make_slotmap, translate_slotmaps_batch
from hugectr_backend_tpu_torch.config.params import EmbeddingCacheType, InferenceParams
from hugectr_backend_tpu_torch.tiers.hbm import (
    DeviceTable,
    scatter_rows,
    translate_indexes_batch,
)
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.cache")


class _HitRateMeter:
    """EWMA hit-rate per table (unobserved tables read 0.0)."""

    def __init__(self, num_tables: int, alpha: float = 0.05):
        self.rates = np.zeros(num_tables, dtype=np.float64)
        self._seen = np.zeros(num_tables, dtype=bool)
        self.alpha = alpha
        self._lock = threading.Lock()

    def update(self, table_idx: int, hits: int, total: int):
        if total == 0:
            return
        with self._lock:
            r = hits / total
            if not self._seen[table_idx]:
                self._seen[table_idx] = True
                self.rates[table_idx] = r
                return
            self.rates[table_idx] += self.alpha * (r - self.rates[table_idx])

    def rate(self, table_idx: int) -> float:
        return float(self.rates[table_idx])


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (the JAX package's bucket grid; the
    fused server's chunk plan relies on the padded group layout)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class EmbeddingCache:
    """One model's embedding cache on one device (the static flavour)."""

    def __init__(
        self,
        params: InferenceParams,
        tables: Sequence[DeviceTable],
        device: torch.device,
        tier_query: Optional[Callable[[int, np.ndarray], tuple[np.ndarray, np.ndarray]]] = None,
    ):
        self.params = params
        self.tables = list(tables)
        self.device = torch.device(device)
        # tier_query(table_idx, keys) -> (vectors, found): the path to the
        # DRAM / SSD tiers, injected by the parameter server.
        self.tier_query = tier_query
        self.hit_meter = _HitRateMeter(len(self.tables))
        self._lock = threading.RLock()
        # Group member tables by physical arena; the group's lookup_kind is
        # fixed at build time.
        self._groups: list[tuple[object, str, list[int]]] = []
        seen: dict = {}
        for t, table in enumerate(self.tables):
            arena = getattr(table, "arena", None)
            gkey = id(arena) if arena is not None else ("solo-table", t)
            if gkey not in seen:
                kind = arena.lookup_kind if arena is not None else "arena"
                if (kind == "onehot" and arena.scales is not None
                        and arena.scales_host is None):
                    # A quantized one-hot group needs host-side scales;
                    # demote to the device-scales gather.
                    kind = "arena"
                seen[gkey] = len(self._groups)
                self._groups.append((arena, kind, []))
            self._groups[seen[gkey]][2].append(t)

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    def nbytes(self) -> int:
        return sum(t.nbytes() for t in self.tables)

    # -- lookup path ---------------------------------------------------------

    def translate(self, table_idx: int, keys: np.ndarray) -> np.ndarray:
        """Host-side key -> slot translation; misses -> default-row slot."""
        return self.tables[table_idx].slots_for(keys)

    def translate_resolve(self, table_idx: int, keys: np.ndarray):
        """Translate one table's keys AND snapshot its device operands under
        ONE lock hold. -> (values, device_scales, slots_int32,
        host_scales_or_None)."""
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        with self._lock:
            slots = self.translate(table_idx, keys)
            table = self.tables[table_idx]
            arena = getattr(table, "arena", None)
            if arena is None:
                return table.values, table.scales, slots.astype(np.int32), None
            gslots = slots.astype(np.int64) + table.offset
            if arena.scales_host is not None:
                return (arena.values, None, gslots.astype(np.int32),
                        arena.scales_host[gslots])
            return arena.values, arena.scales, gslots.astype(np.int32), None

    def _translate_many(self, keys_c):
        """Translate every table's (int64, flat) key run in ONE native batch
        call: all tables' chunks run in parallel on the native pool. Caller
        holds the cache lock."""
        return translate_indexes_batch([t.index for t in self.tables], keys_c)

    def _translate_all(self, keys_per_table):
        """Translate every table's keys under the caller-held lock; updates
        the hit meter. -> (local_slots, counts, miss_info)."""
        keys_c = [np.asarray(k, dtype=np.int64).reshape(-1) for k in keys_per_table]
        local_slots, counts, miss_info = [], [], []
        for t, (keys, slots) in enumerate(zip(keys_c, self._translate_many(keys_c))):
            n = keys.shape[0]
            miss_mask = slots == self.tables[t].index.miss_slot
            self.hit_meter.update(t, int(n - miss_mask.sum()), n)
            local_slots.append(slots)
            counts.append(n)
            miss_info.append((keys, miss_mask))
        return local_slots, counts, miss_info

    def prepare_lookup(self, counts: Sequence[int], local_slots, bucket: bool = True):
        """Host-side assembly of the device-program arguments (call under
        ``self._lock`` so slots and tensor snapshots stay consistent).

        ``bucket``: pad each group's (and each one-hot member's) run to a
        power of two with default-row slots, the layout the fused server's
        chunk plan reads. :meth:`lookup` and :meth:`lookup_flat` slice every
        table's rows out and pass False: on the card the pad is only work.

        -> (vals, dscales, slots_np, scin_np, meta, table_pos) where
        ``meta[g]`` describes group g for lookup_program.lookup_groups and
        ``table_pos[t]`` is the (group, start) of table t's rows in the group
        output."""
        vals_l, dscales_l, slots_l, scin_l, metas = [], [], [], [], []
        table_pos: dict[int, tuple[int, int]] = {}
        for g, (arena, kind, members) in enumerate(self._groups):
            t0 = members[0]
            table0 = self.tables[t0]
            if arena is None:
                vals, dev_scales = table0.values, table0.scales
                scales_host = None
            else:
                vals, dev_scales = arena.values, arena.scales
                scales_host = arena.scales_host
            if kind == "onehot":
                # Per-member bucket padding: the fused server folds this
                # group member by member.
                offs, sizes, pcounts = [], [], []
                slot_parts, start = [], 0
                for t in members:
                    tb = self.tables[t]
                    n = counts[t]
                    pc = _bucket(max(n, 1)) if bucket else max(n, 1)
                    arr = np.full(pc, tb.offset + tb.index.miss_slot, np.int64)
                    arr[:n] = local_slots[t].astype(np.int64) + tb.offset
                    slot_parts.append(arr)
                    offs.append(int(tb.offset))
                    sizes.append(int(tb.block_rows or tb.capacity + 1))
                    pcounts.append(pc)
                    table_pos[t] = (g, start)
                    start += pc
                arr = np.concatenate(slot_parts)
                meta = ("onehot", tuple(offs), tuple(sizes), tuple(pcounts))
                dscales = None
            else:
                if arena is not None:
                    adj = np.concatenate([
                        local_slots[t].astype(np.int64) + self.tables[t].offset
                        for t in members
                    ])
                    pad_slot = table0.offset + table0.index.miss_slot
                else:
                    adj = local_slots[t0].astype(np.int64)
                    pad_slot = table0.index.miss_slot
                total = adj.shape[0]
                arr = np.full(_bucket(max(total, 1)) if bucket else max(total, 1), pad_slot,
                              np.int64)
                arr[:total] = adj
                start = 0
                for t in members:
                    table_pos[t] = (g, start)
                    start += counts[t]
                meta = ("gather",)
                # "solo": scales ride host-side; "arena": device scales.
                if kind == "solo" and scales_host is not None:
                    dscales = None
                else:
                    dscales = dev_scales
                    scales_host = None
            scin = scales_host[arr] if scales_host is not None else None
            vals_l.append(vals)
            dscales_l.append(dscales)
            slots_l.append(arr.astype(np.int32))
            scin_l.append(scin)
            metas.append(meta)
        return vals_l, dscales_l, slots_l, scin_l, tuple(metas), table_pos

    def lookup_flat(self, keys_per_table: Sequence[np.ndarray],
                    pad_counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Like :meth:`lookup` but ONE flat f32 device tensor: table 0's rows,
        then table 1's, ... (the KEYS/NUMKEYS OUTPUT0 layout).

        ``pad_counts[t]`` (optional, >= len(keys_per_table[t])) pads table t's
        run to that many rows with default-row slots, which never count as
        misses."""
        with self._lock:
            local_slots, counts, miss_info = self._translate_all(keys_per_table)
            need_merge = self.tier_query is not None and any(
                m.any() for _, m in miss_info)
            if pad_counts is not None:
                for t, pc in enumerate(pad_counts):
                    pc = int(pc)
                    if pc > counts[t]:
                        pad = np.full(pc - counts[t], self.tables[t].index.miss_slot,
                                      dtype=local_slots[t].dtype)
                        local_slots[t] = np.concatenate([local_slots[t], pad])
                        counts[t] = pc
            vals_l, dscales_l, slots_l, scin_l, metas, table_pos = (
                self.prepare_lookup(counts, local_slots, bucket=False))
        if not need_merge:
            slices = tuple(
                (table_pos[t][0], table_pos[t][1], counts[t])
                for t in range(len(self.tables))
            )
            slots_cat, sb, scin_cat, cb = lookup_program.upload_host_args(
                vals_l, slots_l, scin_l, self.device)
            return lookup_program.lookup_flat(
                vals_l, dscales_l, slots_cat, scin_cat, metas, sb, cb, slices)
        outs = self._lookup_prepared(
            counts, miss_info, vals_l, dscales_l, slots_l, scin_l, metas, table_pos)
        if not outs:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.cat([o.reshape(-1) for o in outs])

    def lookup(self, keys_per_table: Sequence[np.ndarray]) -> list[torch.Tensor]:
        """Full lookup with miss-merge. -> per-table f32 [n_t, dim_t] device
        tensors (views of the group outputs)."""
        with self._lock:
            local_slots, counts, miss_info = self._translate_all(keys_per_table)
            vals_l, dscales_l, slots_l, scin_l, metas, table_pos = (
                self.prepare_lookup(counts, local_slots, bucket=False))
        return self._lookup_prepared(
            counts, miss_info, vals_l, dscales_l, slots_l, scin_l, metas, table_pos)

    def _lookup_prepared(self, counts, miss_info, vals_l, dscales_l, slots_l,
                         scin_l, metas, table_pos) -> list[torch.Tensor]:
        """Gather + tier miss-merge over an already-translated snapshot."""
        slots_cat, sb, scin_cat, cb = lookup_program.upload_host_args(
            vals_l, slots_l, scin_l, self.device)
        gouts = lookup_program.lookup_groups(
            vals_l, dscales_l, slots_cat, scin_cat, metas, sb, cb)
        # Miss merge: rows the device tier does not hold come from the DRAM /
        # SSD tiers, scattered into the group outputs.
        if self.tier_query is not None:
            for t, (keys, miss_mask) in enumerate(miss_info):
                miss_pos = np.flatnonzero(miss_mask)
                if miss_pos.size == 0:
                    continue
                vecs, found = self.tier_query(t, keys[miss_pos])
                fnd_pos = miss_pos[found]
                if fnd_pos.size:
                    g, start = table_pos[t]
                    pos = torch.from_numpy(start + fnd_pos).to(self.device)
                    rows = torch.from_numpy(
                        np.ascontiguousarray(vecs[found], np.float32)).to(self.device)
                    gouts[g] = scatter_rows(gouts[g], pos, rows)
                    self._on_miss_fetched(t, keys[miss_pos][found], vecs[found])
        return [
            gouts[table_pos[t][0]][table_pos[t][1] : table_pos[t][1] + counts[t]]
            for t in range(len(self.tables))
        ]

    def _on_miss_fetched(self, table_idx: int, keys: np.ndarray, vectors: np.ndarray):
        """Insert policy for rows the miss merge fetched; static: none."""
        return

    # -- refresh ---------------------------------------------------------------

    def shutdown(self):
        """Stop the worker threads this cache owns (the refresh pool;
        subclasses add theirs). Model unload calls it, so load/unload cycles
        do not accumulate threads."""
        pool = getattr(self, "_refresh_pool_", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._refresh_pool_ = None

    @property
    def _refresh_pool(self):
        """Refresher pool, sized by ``num_of_refresher_buffer_in_pool``
        (reference docs/hierarchical_parameter_server.md:217-238): per-table
        refresh windows run concurrently, and tier queries never hold the
        cache lock."""
        pool = getattr(self, "_refresh_pool_", None)
        if pool is None:
            # Double-checked under the cache lock: a refresh timer racing a
            # manual refresh must not create two pools.
            with self._lock:
                pool = getattr(self, "_refresh_pool_", None)
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = ThreadPoolExecutor(
                        max_workers=max(self.params.num_of_refresher_buffer_in_pool, 1),
                        thread_name_prefix=f"hps-refresh-{self.params.model_name}")
                    self._refresh_pool_ = pool
        return pool

    def refresh(self, fraction: Optional[float] = None) -> int:
        """Re-pull the resident rows' values from the DRAM / SSD tiers:
        ``cache_refresh_percentage_per_iteration`` of each table per call
        unless ``fraction`` overrides it (reference model_state.cpp:145-178).
        -> rows refreshed. Tier reads and quantization run off the cache
        lock; only the window choice and the scatter hold it."""
        if self.tier_query is None:
            return 0
        frac = (self.params.cache_refresh_percentage_per_iteration
                if fraction is None else fraction)
        futs = [self._refresh_pool.submit(self._refresh_table, t, frac)
                for t in range(len(self.tables))]
        return sum(f.result() for f in futs)

    def _refresh_table(self, t: int, frac: float) -> int:
        table = self.tables[t]
        cap = table.capacity
        if cap == 0:
            return 0
        with self._lock:
            n = max(int(cap * frac), 1) if frac < 1.0 else cap
            # Round-robin window over the sorted key space.
            start = getattr(table, "_refresh_cursor", 0)
            idx = (np.arange(n) + start) % cap
            table._refresh_cursor = int((start + n) % cap)
            keys = table.index.sorted_keys[idx]
        vecs, found = self.tier_query(t, keys)  # off-lock tier read
        if not found.any():
            return 0
        prepared = self._prepare_rows(t, vecs[found])
        with self._lock:
            # Static cache: slot i is the i-th sorted key for good, so the
            # window needs no revalidation after the off-lock read.
            self._apply_prepared(t, idx[found], prepared)
        return int(found.sum())

    def _prepare_rows(self, table_idx: int, vectors: np.ndarray):
        """Quantize rows for :meth:`_apply_prepared` (host work, off the
        cache lock). -> (rows, scales or None)."""
        from hugectr_backend_tpu_torch.ops.quantize import (
            quantize_rows_fp8,
            quantize_rows_int4,
            quantize_rows_int8,
        )

        quant = self.tables[table_idx].quant
        vectors = np.asarray(vectors, np.float32)
        if quant in ("int8", "fp8", "int4"):
            return {"int8": quantize_rows_int8, "fp8": quantize_rows_fp8,
                    "int4": quantize_rows_int4}[quant](vectors)
        return vectors, None

    def _apply_prepared(self, table_idx: int, slots: np.ndarray, prepared):
        """Scatter pre-quantized rows into the table's tensors. Caller holds
        ``self._lock``; the tensors are replaced, never written in place, so
        a lookup that snapshotted them reads the old rows whole."""
        table = self.tables[table_idx]
        arena = getattr(table, "arena", None)
        slots_np = np.asarray(slots, dtype=np.int64)
        if arena is not None:
            slots_np = slots_np + table.offset
        holder = arena if arena is not None else table
        dev = holder.values.device
        slots_d = torch.from_numpy(slots_np).to(dev)
        q, s = prepared
        rows = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(q))
        holder.values = scatter_rows(holder.values, slots_d, rows.to(dev))
        if s is not None:
            holder.scales = scatter_rows(holder.scales, slots_d, torch.from_numpy(s).to(dev))
            # The host copy of the scales (solo/onehot translation-time
            # fetch) follows.
            if getattr(holder, "scales_host", None) is not None:
                holder.scales_host[slots_np] = s


class DynamicEmbeddingCache(EmbeddingCache):
    """DYNAMIC / STOCHASTIC flavours (and UVM's base): online insert on miss.

    Capacity is fixed (``gpucacheper`` x table rows); each table's SlotMap
    owns the key -> slot index and evicts the least-recently-used resident.
    Inserts run synchronously while the table's hit rate is below
    ``hit_rate_threshold`` (a cold cache fills fast) and through a bounded
    queue drained by one worker above it (a hot cache never blocks the
    lookup stream). Queue overflow drops the newest batch and counts it in
    ``dropped_inserts``: the tiers stay authoritative."""

    def __init__(self, params, tables, device, tier_query=None):
        super().__init__(params, tables, device=device, tier_query=tier_query)
        self.slotmaps = []
        for t in self.tables:
            sm = make_slotmap(t.capacity)
            if t.capacity:
                # Resident rows were written sorted: slot i is the i-th
                # sorted key (acquire hands free slots out from 0 up).
                sm.acquire(t.index.sorted_keys)
            self.slotmaps.append(sm)
        self._rng = np.random.default_rng(0)
        # Pending batches coalesce per table; quantization runs off the
        # cache lock, and only slot acquisition + the scatter hold it. The
        # depth is bounded by the worker buffer pool (reference
        # docs/hierarchical_parameter_server.md:217-225).
        self._pending = deque()
        self._pending_cv = threading.Condition()
        self._max_pending = max(4 * params.num_of_worker_buffer_in_pool, 8)
        self.dropped_inserts = 0
        self._stop_drainer = False
        self._drain_busy = False
        self._drainer = threading.Thread(
            target=self._drain_loop, daemon=True,
            name=f"hps-insert-{params.model_name}")
        self._drainer_started = False

    def translate(self, table_idx: int, keys: np.ndarray) -> np.ndarray:
        # Under the cache lock: a key never becomes visible between slot
        # acquisition and its row write in _insert.
        with self._lock:
            return self.slotmaps[table_idx].translate(keys)

    def _translate_many(self, keys_c):
        # One native call, tables in parallel (each SlotMap has its own C++
        # mutex); the same cache-lock pairing as translate().
        with self._lock:
            return translate_slotmaps_batch(self.slotmaps, keys_c)

    def _on_miss_fetched(self, table_idx, keys, vectors):
        if keys.shape[0] == 0:
            return
        if self.params.embedding_cache_type == EmbeddingCacheType.STOCHASTIC:
            pick = self._rng.random(keys.shape[0]) < 0.5
            keys, vectors = keys[pick], vectors[pick]
            if keys.shape[0] == 0:
                return
        if self.hit_meter.rate(table_idx) < self.params.hit_rate_threshold:
            self._insert(table_idx, keys, vectors)
            return
        with self._pending_cv:
            if not self._drainer_started:
                self._drainer.start()
                self._drainer_started = True
            if len(self._pending) >= self._max_pending:
                self.dropped_inserts += 1
                return
            self._pending.append((table_idx, keys.copy(), vectors.copy()))
            self._pending_cv.notify()

    def _insert(self, table_idx, keys, vectors):
        # Quantize off the lock; acquisition and the scatter pair under it (a
        # key must never translate to its slot before its row is there).
        prepared = self._prepare_rows(table_idx, vectors)
        with self._lock:
            slots, _evicted = self.slotmaps[table_idx].acquire(keys)
            live = slots >= 0  # -1: not insertable (a zero-capacity map)
            if not live.all():
                if not live.any():
                    return
                prepared = _select_rows(prepared, live)
                slots = slots[live]
            self._apply_prepared(table_idx, slots, prepared)

    def _drain_loop(self):
        while True:
            with self._pending_cv:
                while not self._pending and not self._stop_drainer:
                    self._pending_cv.wait()
                if self._stop_drainer and not self._pending:
                    return
                batch = list(self._pending)
                self._pending.clear()
                self._drain_busy = True
            # Coalesce per table; for a duplicate key the LAST enqueued row
            # wins (np.unique keeps the first occurrence, so reverse first).
            # A failing insert must not kill the drainer: log it, count it as
            # dropped, keep draining.
            try:
                per_table: dict[int, list] = {}
                for t, k, v in batch:
                    per_table.setdefault(t, []).append((k, v))
                for t, parts in per_table.items():
                    keys = np.concatenate([k for k, _ in parts])[::-1]
                    vecs = np.concatenate([v for _, v in parts])[::-1]
                    _, first = np.unique(keys, return_index=True)
                    try:
                        self._insert(t, keys[first], vecs[first])
                    except Exception:
                        log.exception(
                            "async insert failed for table %d (%d keys dropped; "
                            "the tiers remain authoritative)", t, int(first.size))
                        self.dropped_inserts += 1
            finally:
                with self._pending_cv:
                    self._drain_busy = False
                    self._pending_cv.notify_all()

    def pending_inserts(self) -> int:
        with self._pending_cv:
            return len(self._pending)

    def _refresh_table(self, t: int, frac: float) -> int:
        """Refresh a window of the resident keys: the tier query and the
        quantization run off the lock, the write is revalidated under it."""
        keys, slots = self.slotmaps[t].resident()
        n_res = keys.shape[0]
        if n_res == 0:
            return 0
        n = max(int(n_res * frac), 1) if frac < 1.0 else n_res
        start = getattr(self.tables[t], "_refresh_cursor", 0) % n_res
        idx = (np.arange(n) + start) % n_res
        self.tables[t]._refresh_cursor = int((start + n) % n_res)
        vecs, found = self.tier_query(t, keys[idx])
        if not found.any():
            return 0
        prepared_all = self._prepare_rows(t, vecs[found])
        with self._lock:
            # Inserts may have moved keys while the tier query ran: write
            # only rows whose key still owns the same slot.
            cur = self.slotmaps[t].translate(keys[idx], touch=False)
            ok = found & (cur == slots[idx])
            if not ok.any():
                return 0
            self._apply_prepared(t, slots[idx][ok], _select_rows(prepared_all, ok[found]))
            return int(ok.sum())

    def drain_pending(self, timeout: float = 5.0) -> bool:
        """Wait until the async-insert queue is empty. -> False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._pending_cv:
                if not self._pending and not self._drain_busy:
                    return True
            time.sleep(0.002)
        return False

    def shutdown(self):
        with self._pending_cv:
            self._stop_drainer = True
            self._pending_cv.notify_all()
        if self._drainer_started:
            self._drainer.join(timeout=10)
        super().shutdown()


class UvmEmbeddingCache(DynamicEmbeddingCache):
    """UVM flavour: the full table is pinned in the DRAM tier (the parameter
    server loads it at ``initial_cache_rate`` 1.0), misses are served from
    there and counted, not inserted; the next ``refresh()`` admits the
    hottest missed keys (evicting LRU residents), then refreshes the resident
    window."""

    def __init__(self, params, tables, device, tier_query=None):
        super().__init__(params, tables, device=device, tier_query=tier_query)
        # Missed keys as raw fragments, appended O(1) per request and reduced
        # in bulk at refresh time.
        self._miss_frags: list[list[np.ndarray]] = [[] for _ in self.tables]
        self._miss_lock = threading.Lock()

    def _on_miss_fetched(self, table_idx, keys, vectors):
        if keys.shape[0] == 0:
            return
        with self._miss_lock:
            self._miss_frags[table_idx].append(keys.copy())

    def _refresh_table(self, t: int, frac: float) -> int:
        with self._miss_lock:
            frags = self._miss_frags[t]
            self._miss_frags[t] = []
        if frags and self.tier_query is not None:
            uniq, counts = np.unique(np.concatenate(frags), return_counts=True)
            hot = uniq[np.argsort(-counts, kind="stable")]
            cap = self.tables[t].capacity
            n_admit = max(int(cap * frac), 1) if frac < 1.0 else cap
            admit_keys = hot[:n_admit]
            vecs, found = self.tier_query(t, admit_keys)
            if found.any():
                self._insert(t, admit_keys[found], vecs[found])
        return super()._refresh_table(t, frac)

    def pending_admissions(self, table_idx: int) -> int:
        with self._miss_lock:
            frags = self._miss_frags[table_idx]
            if not frags:
                return 0
            return int(np.unique(np.concatenate(frags)).size)


def _select_rows(prepared, mask: np.ndarray):
    """The rows of a ``_prepare_rows`` result where ``mask`` is set."""
    q, s = prepared
    if isinstance(q, torch.Tensor):  # fp8 rows
        q = q[torch.from_numpy(np.ascontiguousarray(mask))]
    else:
        q = q[mask]
    return q, None if s is None else s[mask]
