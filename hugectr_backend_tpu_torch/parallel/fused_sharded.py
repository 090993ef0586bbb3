"""Sharded fused serving: the sharded lookup and the dense forward in one call.

Port of the JAX package's parallel/fused_sharded.py (BASELINE config 3,
"DCN-v2 with multi-table embeddings sharded", generalised to any model that
reads per-table [B, K_t, D_t] blocks). The tables are row-sharded over the
mesh's shard axis (ShardedTable); every table's gathers run in one K1 launch
per device; the dense forward runs on the mesh's output device. The JAX
package splits the batch over the ``data`` axis; here it is split only
where that axis holds distinct devices (one forward per device, each on a
replica of the model): on one card the split would be sequential forwards
for nothing.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import _bucket as _bucket_pow2
from hugectr_backend_tpu_torch.parallel.mesh import Mesh
from hugectr_backend_tpu_torch.parallel.sharded_table import (
    STRATEGIES,
    ShardedTable,
    lookup_tables,
    route,
)


class ShardedFusedServer:
    """Fused sharded serving for models consuming per-table [B, K_t, D_t].

    ``assemble_fn(dense, embs) -> logits`` receives the lookup blocks on the
    device of ``dense``. ``strategy`` picks the sharded lookup
    (parallel/sharded_table.py): "all_to_all" (the default; host dedup and
    bucket routing) or "psum"."""

    def __init__(self, mesh: Mesh, tables: Sequence[ShardedTable],
                 keys_per_sample: Sequence[int], assemble_fn: Callable,
                 strategy: str = "all_to_all"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.mesh = mesh
        self.tables = list(tables)
        self.keys_per_sample = list(keys_per_sample)
        self.assemble_fn = assemble_fn
        self.strategy = strategy
        # One forward per distinct device along the data axis.
        self.data_devices = list(dict.fromkeys(mesh.data_devices()))

    def _forward(self, dense: torch.Tensor, embs: list) -> torch.Tensor:
        if len(self.data_devices) == 1:
            return self.assemble_fn(dense, embs)
        out_dev = dense.device
        chunks = np.array_split(np.arange(dense.shape[0]), len(self.data_devices))
        outs = []
        for dev, idx in zip(self.data_devices, chunks):
            if not idx.size:
                continue
            a, b = int(idx[0]), int(idx[-1]) + 1
            outs.append(self.assemble_fn(dense[a:b].to(dev),
                                         [e[a:b].to(dev) for e in embs]).to(out_dev))
        return torch.cat(outs)

    def predict(self, keys_per_table, dense: np.ndarray) -> torch.Tensor:
        """keys_per_table[t]: [B, K_t] (or flat B * K_t); dense [B, Nd].
        -> logits on the mesh's output device."""
        dense = np.asarray(dense, dtype=np.float32)
        b = dense.shape[0]
        # Pad the batch to the pow2 bucket grid (miss-slot pads, zero dense
        # rows, sliced off below), as the JAX package does to bound its
        # compiles; here the pad rows are only work, kept so that the two
        # packages' plans stay comparable.
        b_pad = _bucket_pow2(b)
        if b_pad != b:
            dense = np.concatenate(
                [dense, np.zeros((b_pad - b, dense.shape[1]), np.float32)])
        routed = []
        for t, keys in enumerate(keys_per_table):
            k = self.keys_per_sample[t]
            keys = np.asarray(keys, np.int64).reshape(b * k)
            slots = self.tables[t].slots_for(keys)
            if b_pad != b:
                slots = np.concatenate([
                    slots,
                    np.full((b_pad - b) * k, self.tables[t].index.miss_slot, slots.dtype),
                ])
            routed.append(route(self.tables[t], slots, self.strategy))
        with torch.inference_mode():
            flats = lookup_tables(self.tables, routed, self.strategy)
            embs = [f.view(b_pad, k, f.shape[-1]) for f, k in zip(flats, self.keys_per_sample)]
            dense_d = torch.from_numpy(dense).to(self.mesh.out_device)
            out = self._forward(dense_d, embs)
        return out if b_pad == b else out[:b]


def make_sharded_stacked_server(mesh: Mesh, tables, keys_per_sample, model,
                                strategy: str = "all_to_all") -> ShardedFusedServer:
    """Fused sharded serving for any model consuming the per-table
    embeddings stacked on the feature axis (DLRM, DCN-v2, xDeepFM, ...):
    ``model(dense, emb [B, sum K_t, D])``. ``model`` (an ``nn.Module`` of
    this package, e.g. ``models.dcn.DCNv2`` or ``models.dlrm.DLRM``) is moved
    to the mesh's output device, with a replica on every other distinct
    device of the data axis."""
    model = model.to(mesh.out_device).eval()
    replicas = {str(mesh.out_device): model}

    def assemble(dense, embs):
        m = replicas.get(str(dense.device))
        if m is None:
            m = replicas[str(dense.device)] = copy.deepcopy(model).to(dense.device)
        return m(dense, torch.cat(embs, dim=1))

    return ShardedFusedServer(mesh, tables, keys_per_sample, assemble, strategy=strategy)


# Model-family aliases (identical assembly; kept for call-site clarity).
make_sharded_dcn_server = make_sharded_stacked_server
make_sharded_dlrm_server = make_sharded_stacked_server
