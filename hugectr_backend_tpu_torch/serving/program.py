"""Fused DLRM serving: lookup + dense forward on one device, no host trip.

Port of the JAX package's serving/program.py (``FusedMultiTableServer`` on
its chunked path, and ``make_dlrm_multi_server``). The lookup outputs reach
the interaction CHUNKED (:class:`EmbParts`: one block per lookup group), so
the [B, T, D] stack never materializes. By default the one-hot lookup group
is not looked up at all: it is folded into the interaction kernel (K3), its
features moved to the front of the feature order, with the first top-MLP
weight's columns permuted to keep the logits exact. ``HPS_OH_IN_KERNEL=0``
keeps the group in the lookup (K1) and runs K2 instead. Without a fold the
features are reordered part-major, as in the JAX package.

The other model servers of the JAX file (WDL, DCN, DeepFM, xDeepFM, NCF,
MMoE) are ROADMAP queue A item 5.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache
from hugectr_backend_tpu_torch.config.params import InferenceParams
from hugectr_backend_tpu_torch.ops.fused_interaction import (
    EmbParts,
    interaction_permutation,
    is_part_major,
    part_major_order,
)


class FusedMultiTableServer:
    """Serve a model that consumes one embedding block per table against an
    :class:`EmbeddingCache`: the host translates keys, the device gathers
    and runs ``assemble_fn(dense, embs, order)``, where ``embs`` is an
    :class:`EmbParts` (one key per table, one dim) or the stacked
    [B, sum K_t, D] tensor, and ``order`` (or None) is the feature order
    the interaction sees (new position i holds original feature order[i])."""

    def __init__(self, params: InferenceParams, cache: EmbeddingCache, assemble_fn):
        self.params = params
        self.cache = cache
        self.assemble_fn = assemble_fn
        self.keys_per_sample = list(params.maxnum_catfeature_query_per_table_per_sample)

    def _forward(self, vals, dscales, slots, scin, dense, batch, meta, slices):
        gather = lookup_program.gather_rows_for_groups
        chunk_plan = (
            self._chunk_plan(slices, {g: int(slots[g].shape[0])
                                      for g in {s[0] for s in slices}})
            if all(k == 1 and d == slices[0][4] for (_, _, _, k, d) in slices)
            else None
        )
        order = None
        if chunk_plan is None:
            gouts = gather(vals, dscales, slots, scin, meta)
            embs = torch.cat([
                gouts[g][start : start + cnt].reshape(batch, k, d)
                for (g, start, cnt, k, d) in slices
            ], dim=1)
            return self.assemble_fn(dense, embs, order)
        d = slices[0][4]
        group_shape, fmap = chunk_plan
        fold = self._fold_oh_plan(meta, group_shape, fmap)
        if fold is not None:
            pi, members, ord_l, fmap_rest, rest_parts = fold
            g_oh = group_shape[pi][0]
            stride = group_shape[pi][2]
            n_oh = len(members)
            # The kernel reads the first `batch` entries of each member row.
            slots_oh = slots[g_oh].view(n_oh, stride)
            sc = scin[g_oh]
            scales_oh = sc.view(n_oh, stride) if sc is not None else None
            meta_eff = tuple(("skip",) if g == g_oh else m for g, m in enumerate(meta))
            gouts = gather(vals, dscales, slots, scin, meta_eff)
            parts = [gouts[g].view(nblk, stride_, d) for (g, nblk, stride_) in rest_parts]
            if ord_l != tuple(range(len(fmap))):
                order = ord_l
            embs = EmbParts(parts, fmap_rest, batch,
                            oh=(vals[g_oh], slots_oh, scales_oh, members))
        else:
            gouts = gather(vals, dscales, slots, scin, meta)
            parts = [gouts[g].view(nblk, stride, d) for (g, nblk, stride) in group_shape]
            if not is_part_major(fmap):
                o, fmap = part_major_order(fmap)
                order = tuple(o)
            embs = EmbParts(parts, fmap, batch)
        return self.assemble_fn(dense, embs, order)

    @staticmethod
    def _fold_oh_plan(meta, group_shape, fmap):
        """Whether (and how) to fold a one-hot lookup group into the
        interaction kernel. -> (part_idx, members, order, fmap_rest,
        rest_parts) or None. ``order``: the one-hot features first in member
        order, then the rest part-major. ``HPS_OH_IN_KERNEL=0`` turns the
        fold off (K2 instead of K3)."""
        if os.environ.get("HPS_OH_IN_KERNEL", "1") == "0":
            return None
        oh_parts = [i for i, (g, _n, _s) in enumerate(group_shape)
                    if meta[g][0] == "onehot"]
        if len(oh_parts) != 1:
            return None
        pi = oh_parts[0]
        g, nblk, stride = group_shape[pi]
        _, offs, sizes, pcounts = meta[g]
        members = tuple(zip(offs, sizes))
        if nblk != len(members) or any(pc != stride for pc in pcounts):
            return None
        oh_feats = sorted((t for t in range(len(fmap)) if fmap[t][0] == pi),
                          key=lambda t: fmap[t][1])
        if [fmap[t][1] for t in oh_feats] != list(range(len(members))):
            return None
        rest = sorted((t for t in range(len(fmap)) if fmap[t][0] != pi),
                      key=lambda t: fmap[t])
        order = tuple(oh_feats + rest)
        rest_parts = tuple(gs for i, gs in enumerate(group_shape) if i != pi)
        pmap = {old: new for new, old in
                enumerate(i for i in range(len(group_shape)) if i != pi)}
        fmap_rest = tuple((pmap[fmap[t][0]], fmap[t][1]) for t in rest)
        return pi, members, order, fmap_rest, rest_parts

    @staticmethod
    def _chunk_plan(slices, group_rows):
        """-> ([(g, nblocks, stride)], fmap) mapping each table to a block
        of its group's output, or None when the layout is not uniformly
        blocked (then the caller stacks the tables)."""
        used = sorted({g for (g, *_r) in slices})
        gpos = {g: i for i, g in enumerate(used)}
        strides = {}
        for g in used:
            starts = sorted(s[1] for s in slices if s[0] == g)
            if len(starts) == 1:
                stride = group_rows[g]
            else:
                diffs = {b - a for a, b in zip(starts, starts[1:])}
                if len(diffs) != 1:
                    return None
                stride = diffs.pop()
            if stride <= 0 or group_rows[g] % stride:
                return None
            if any(s % stride for s in starts):
                return None
            strides[g] = stride
        group_shape = tuple((g, group_rows[g] // strides[g], strides[g]) for g in used)
        fmap = tuple((gpos[g], start // strides[g]) for (g, start, _c, _k, _d) in slices)
        return group_shape, fmap

    def predict(self, keys_per_table, dense) -> torch.Tensor:
        """keys_per_table[t]: [B, K_t] (or flat B*K_t); dense [B, Nd].
        -> logits on the cache's device."""
        dense = np.asarray(dense, dtype=np.float32)
        b = dense.shape[0]
        cache = self.cache
        counts, local_slots = [], []
        with cache._lock:
            for t, keys in enumerate(keys_per_table):
                keys = np.asarray(keys, dtype=np.int64).reshape(b * self.keys_per_sample[t])
                local_slots.append(cache.translate(t, keys))
                counts.append(keys.shape[0])
            vals, dscales, slots, scin, meta, table_pos = cache.prepare_lookup(
                counts, local_slots)
        slices = tuple(
            (table_pos[t][0], table_pos[t][1], counts[t], self.keys_per_sample[t],
             cache.tables[t].dim)
            for t in range(len(cache.tables))
        )
        slots_cat, sb, scin_cat, cb = lookup_program.upload_host_args(
            vals, slots, scin, cache.device)
        slots_d, scin_d = lookup_program._unpack_device_args(slots_cat, scin_cat, sb, cb)
        dense_d = torch.from_numpy(dense).to(cache.device)
        with torch.inference_mode():
            return self._forward(vals, dscales, slots_d, scin_d, dense_d, b, meta, slices)


def make_dlrm_multi_server(params, cache, model) -> FusedMultiTableServer:
    """DLRM over many tables, one categorical feature per table (the Criteo
    layout). ``model`` is a :class:`~hugectr_backend_tpu_torch.models.dlrm.DLRM`;
    it is moved to the cache's device. Models with K_t > 1 or mixed dims get
    the stacked tensor."""
    model = model.to(cache.device).eval()
    permuted: dict = {}

    def assemble(dense, emb, order=None):
        if order is None:
            return model(dense, emb)
        w = permuted.get(order)
        if w is None:
            src = torch.from_numpy(interaction_permutation(order, model.bottom_widths[-1]))
            w0 = model.top.layers[0].weight
            w = permuted[order] = w0[:, src.to(w0.device)].contiguous()
        return model(dense, emb, top_weight0=w)

    return FusedMultiTableServer(params, cache, assemble)
