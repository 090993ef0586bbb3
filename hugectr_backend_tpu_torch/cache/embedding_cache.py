"""Device embedding cache: per-model, per-device hot-row store.

Port of the JAX package's STATIC ``EmbeddingCache`` (its
cache/embedding_cache.py:98-470): the resident set is fixed at creation and
there is no online insert. Lookups are translate (host) -> gather + dequant
(device, K1) -> miss merge (rows that the device tier does not hold come
from the DRAM tier and are scattered into the result).

Invariants kept from the JAX package:
- translation and the operand snapshot happen under ONE hold of ``_lock``;
- tables are functional: writers replace a tensor, never write into one a
  reader holds;
- padding maps to the default row (slot == capacity): misses need no masking.

``refresh`` re-pulls the resident rows from the DRAM tier (``ModelManager``
calls it on a version bump and every ``refresh_interval``). The dynamic,
stochastic and UVM caches are ROADMAP queue A item 3.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.config.params import InferenceParams
from hugectr_backend_tpu_torch.tiers.hbm import (
    DeviceTable,
    scatter_rows,
    translate_indexes_batch,
)


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
    """One model's static embedding cache on one device."""

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
        # DRAM tier, injected by the parameter server.
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

    def prepare_lookup(self, counts: Sequence[int], local_slots):
        """Host-side assembly of the device-program arguments (call under
        ``self._lock`` so slots and tensor snapshots stay consistent).

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
                    pc = _bucket(max(n, 1))
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
                arr = np.full(_bucket(max(total, 1)), pad_slot, np.int64)
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
                self.prepare_lookup(counts, local_slots))
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
                self.prepare_lookup(counts, local_slots))
        return self._lookup_prepared(
            counts, miss_info, vals_l, dscales_l, slots_l, scin_l, metas, table_pos)

    def _lookup_prepared(self, counts, miss_info, vals_l, dscales_l, slots_l,
                         scin_l, metas, table_pos) -> list[torch.Tensor]:
        """Gather + tier miss-merge over an already-translated snapshot."""
        slots_cat, sb, scin_cat, cb = lookup_program.upload_host_args(
            vals_l, slots_l, scin_l, self.device)
        gouts = lookup_program.lookup_groups(
            vals_l, dscales_l, slots_cat, scin_cat, metas, sb, cb)
        # Miss merge: rows the device tier does not hold come from the DRAM
        # tier, scattered into the group outputs.
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
        return [
            gouts[table_pos[t][0]][table_pos[t][1] : table_pos[t][1] + counts[t]]
            for t in range(len(self.tables))
        ]

    # -- refresh ---------------------------------------------------------------

    def shutdown(self):
        """Stop the refresh pool (model unload: load/unload cycles must not
        accumulate threads)."""
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
        """Re-pull the resident rows' values from the DRAM tier:
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
