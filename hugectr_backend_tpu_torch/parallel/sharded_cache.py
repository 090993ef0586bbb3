"""ShardedEmbeddingCache: the EmbeddingCache surface over mesh-sharded tables.

Port of the JAX package's parallel/sharded_cache.py. When a model's ps.json
sets ``shard_tables``, the parameter server builds this cache instead of a
per-device EmbeddingCache, and the serving stack (LookupSession,
ContinuousBatcher, the HTTP / gRPC front ends, ModelManager) runs on top of
it unchanged: capacity partitioning by configuration, the counterpart of the
reference's ``num_partitions`` over Redis nodes. Each table is row-sharded
over the mesh (interleaved placement, parallel/sharded_table.py), and every
table of a request is served by ONE K1 launch per device.

Serving-facing contract (what scheduler.py / session.py / model_manager.py
touch): ``tables`` (with .capacity / .dim), ``num_tables``, ``hit_meter``,
``device`` (the output device, where the batcher's worker runs),
``lookup``, ``lookup_flat(pad_counts=...)``, ``refresh``, ``shutdown``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import _bucket, _HitRateMeter
from hugectr_backend_tpu_torch.config.params import ConfigError, InferenceParams
from hugectr_backend_tpu_torch.parallel.mesh import Mesh, mesh_1d
from hugectr_backend_tpu_torch.parallel.sharded_table import (
    ShardedTable,
    lookup_tables,
    route,
    sharded_lookup,
)


def build_shard_mesh(params: InferenceParams, device=None) -> Mesh:
    """Mesh over the model's ``shard_devices`` (= deployed_device_list or its
    first ``num_shards`` entries), axis named ``table_shard_axis``.

    ``device``: None puts id ``d`` on ``cuda:d`` (an id past the visible
    cards raises ``ConfigError``); a device (``"cpu"``, ``"cuda:<i>"``) takes
    every id (several shards on one device, the counterpart of the JAX
    tests' virtual devices)."""
    ids = params.shard_devices
    if device is not None:
        return mesh_1d([torch.device(device)] * len(ids), params.table_shard_axis)
    visible = torch.cuda.device_count()
    missing = [d for d in ids if d >= visible]
    if missing:
        raise ConfigError(
            f"model {params.model_name!r}: deployed_device_list entries "
            f"{missing} out of range; {visible} devices visible"
        )
    return mesh_1d([torch.device("cuda", d) for d in ids], params.table_shard_axis)


class ShardedEmbeddingCache:
    """One model's embedding tables row-sharded over a device mesh.

    Fully resident by construction: config validation requires gpucacheper
    1.0 and a static cache for shard_tables, so every tier-resident row lives
    on some shard and a miss resolves to the default row (there is no
    per-request tier miss-merge on the sharded path; ``refresh`` is how keys
    streamed into the tiers arrive, via ``tier_keys``). The hit meter tracks
    key-translation hits, as the single-device cache's does.

    Tables are functional (refresh REPLACES a table object); each request
    snapshots the table list once under the lock and uses that snapshot for
    both translation and the device operands, so slots and rows agree.
    """

    def __init__(
        self,
        params: InferenceParams,
        tables: Sequence[ShardedTable],
        mesh: Mesh,
        tier_query: Optional[Callable] = None,
        tier_keys: Optional[Callable] = None,
    ):
        self.params = params
        self.tables = list(tables)
        self.mesh = mesh
        self.device = mesh.out_device
        self.tier_query = tier_query
        # tier_keys(table_idx) -> every key the lower tiers hold now: lets
        # refresh DISCOVER keys streamed in since the build.
        self.tier_keys = tier_keys
        self.hit_meter = _HitRateMeter(len(self.tables))
        self._lock = threading.Lock()
        self.strategy = params.shard_strategy
        self.axis = params.table_shard_axis
        for t in self.tables:
            if self.axis not in t.mesh.axis_names:
                raise ConfigError(
                    f"model {params.model_name!r}: sharded table not on "
                    f"axis {self.axis!r}"
                )

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    # ----------------------------------------------------------- translation

    def _route(self, table: ShardedTable, t: int, keys, pad_to: Optional[int]):
        """keys -> the routed lookup of one table. Padding (to the batcher's
        pow2 bucket) happens at the SLOT level with the miss slot, so pads
        never miss and never skew the hit meter, which counts real keys."""
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        slots = table.slots_for(keys)
        self.hit_meter.update(
            t, int((slots != table.index.miss_slot).sum()), keys.shape[0]
        )
        if pad_to is not None and pad_to > slots.shape[0]:
            slots = np.concatenate([
                slots,
                np.full(pad_to - slots.shape[0], table.index.miss_slot, slots.dtype),
            ])
        return route(table, slots, self.strategy)

    def _run(self, keys_per_table, pad_counts) -> list:
        if len(keys_per_table) != self.num_tables:
            raise ValueError(
                f"got {len(keys_per_table)} key arrays for "
                f"{self.num_tables} tables"
            )
        with self._lock:
            tables = list(self.tables)
        routed = [
            self._route(tables[t], t, keys_per_table[t],
                        None if pad_counts is None else pad_counts[t])
            for t in range(len(tables))
        ]
        with torch.inference_mode():
            return lookup_tables(tables, routed, self.strategy)

    # ---------------------------------------------------------------- lookup

    def lookup(self, keys_per_table: Sequence[np.ndarray]) -> list:
        """Per-table [n_t, dim_t] f32 lookup, one K1 launch per device for
        every table. Counts pad to the pow2 bucket grid with miss slots, as
        in the JAX package (the pad rows are gathered and sliced off)."""
        counts = [np.asarray(k).reshape(-1).shape[0] for k in keys_per_table]
        pad_counts = [_bucket(max(n, 1)) for n in counts]
        outs = self._run(keys_per_table, pad_counts)
        return [o[:n] for o, n in zip(outs, counts)]

    def lookup_flat(self, keys_per_table, pad_counts=None) -> torch.Tensor:
        """Single flat f32 OUTPUT0 vector (table-major, runs padded to
        ``pad_counts`` rows, each table's to its pow2 bucket when None): the
        front end's hot path, the contract of EmbeddingCache.lookup_flat."""
        if pad_counts is None:
            pad_counts = [_bucket(max(np.asarray(k).reshape(-1).shape[0], 1))
                          for k in keys_per_table]
        outs = self._run(keys_per_table, pad_counts)
        if not outs:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.cat([o.reshape(-1) for o in outs])

    # ------------------------------------------------------------- lifecycle

    def refresh(self, fraction: Optional[float] = None) -> int:
        """Re-pull values from the lower tiers and REPLACE each table. Sharded
        tables refresh whole (one quantize and upload per table);
        ``fraction`` is accepted for interface parity and ignored.

        Resident keys the tiers no longer hold KEEP their current values
        (looked up from the old table before the rebuild), as the
        single-device refresh scatters only found rows."""
        if self.tier_query is None:
            return 0
        total = 0
        for t in range(self.num_tables):
            old = self.tables[t]
            keys = old.index.sorted_keys
            if self.tier_keys is not None:
                # Union in keys streamed into the tiers since the build.
                keys = np.union1d(keys, np.asarray(self.tier_keys(t)))
            vecs, found = self.tier_query(t, keys)
            if not found.any():
                continue
            vecs = np.asarray(vecs, np.float32)
            if not found.all():
                missing = keys[~found]
                slots = old.slots_for(missing)
                # A key absent from BOTH the tiers and the old table (listed
                # by tier_keys, evicted before tier_query ran) is DROPPED,
                # not rebuilt from the default row.
                in_old = slots != old.index.miss_slot
                if not in_old.all():
                    drop = np.zeros(len(keys), bool)
                    drop[np.flatnonzero(~found)[~in_old]] = True
                    keys = keys[~drop]
                    vecs = vecs[~drop]
                    found = found[~drop]
                    missing = missing[in_old]
                    slots = slots[in_old]
                if missing.size:
                    with torch.inference_mode():
                        rows = sharded_lookup(old, slots, strategy=self.strategy)
                    vecs = vecs.copy()
                    vecs[~found] = rows.cpu().numpy()
            rebuilt = ShardedTable.from_numpy(
                keys, vecs, old.mesh, quant=old.quant,
                default_value=float(self.params.default_value_for_table(t)),
            )
            with self._lock:
                self.tables[t] = rebuilt
            total += int(found.sum())
        return total

    def shutdown(self):
        return None
