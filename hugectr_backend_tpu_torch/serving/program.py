"""Fused serving: lookup + dense forward on one device, no host trip.

Port of the JAX package's serving/program.py: ``make_dlrm_forward`` and
``FusedDlrmServer`` (one table, K keys per sample: K1 gathers the rows, the
stacked [B, K, D] goes to K4), ``FusedMultiTableServer`` and the model
servers built on it. Each predict gathers every table of the model in one
K1 launch (``lookup_program.lookup_groups``, one launch for all the lookup
groups).

``FusedMultiTableServer(..., chunked=False)`` (the default) hands the model
a list of per-table [B, K_t, D_t] blocks: ``make_wdl_server``,
``make_deepfm_server`` and ``make_ncf_server`` read tables 0 and 1,
``make_dcn_server``, ``make_xdeepfm_server`` and ``make_mmoe_server`` stack
all tables on the feature axis (equal dims). ``use_mixed_precision`` gives
their products bf16 operands with f32 sums.

``chunked=True`` is DLRM's path (``make_dlrm_multi_server``): the lookup
outputs reach the interaction CHUNKED (:class:`EmbParts`: one block per
lookup group), so the [B, T, D] stack never materializes. By default the
one-hot lookup group is not looked up at all: it is folded into the
interaction kernel (K3), its features moved to the front of the feature
order, with the first top-MLP weight's columns permuted to keep the logits
exact. ``HPS_OH_IN_KERNEL=0`` keeps the group in the lookup (K1) and runs K2
instead. Without a fold the features are reordered part-major, as in the
JAX package; with K_t > 1 or mixed dims the tables are stacked. A quantized
DLRM (``quant_fmt``) is served the same way, its first top layer's
``kernel_q`` columns permuted instead of the weight's; ``use_mixed_precision``
gives the dense products bf16 operands with f32 sums.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache
from hugectr_backend_tpu_torch.config.params import InferenceParams
from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
from hugectr_backend_tpu_torch.ops.fused_interaction import (
    EmbParts,
    interaction_permutation,
    is_part_major,
    part_major_order,
)
from hugectr_backend_tpu_torch.ops.quant_matmul import k5_rows


def make_dlrm_forward(model, keys_per_sample: int):
    """-> ``forward(values, scales, slots, scin, dense)``: K1 gathers and
    dequantizes ``slots`` [B * keys_per_sample] int32 (``scin``: per-key
    scales or None), the rows are viewed as [B, keys_per_sample, D] and the
    DLRM ``model`` runs on them (K4 for the interaction). -> logits [B]."""

    def forward(values, scales, slots, scin, dense):
        flat = gather_dequant(values, scales, slots, scin)
        emb = flat.view(dense.shape[0], keys_per_sample, flat.shape[-1])
        return model(dense, emb)

    return forward


class FusedDlrmServer:
    """Serve a DLRM end to end against one table of an
    :class:`EmbeddingCache`: the host translates keys to slots, the device
    gathers (K1) and runs the model (K4 for the interaction). ``model`` is a
    :class:`~hugectr_backend_tpu_torch.models.dlrm.DLRM` (f32 or quantized);
    it is moved to the cache's device. Thread-safe like a LookupSession."""

    def __init__(self, params: InferenceParams, cache: EmbeddingCache, model,
                 table_idx: int = 0):
        if cache.num_tables <= table_idx:
            raise ValueError("cache does not hold the requested table")
        self.params = params
        self.cache = cache
        self.model = model.to(cache.device).eval()
        self.table_idx = table_idx
        self.keys_per_sample = params.maxnum_catfeature_query_per_table_per_sample[table_idx]
        self._forward = make_dlrm_forward(self.model, self.keys_per_sample)

    def predict(self, keys, dense) -> torch.Tensor:
        """keys [B, keys_per_sample] or flat; dense [B, num_dense].
        -> logits [B] on the cache's device."""
        dense = np.asarray(dense, dtype=np.float32)
        b = dense.shape[0]
        keys = np.asarray(keys, dtype=np.int64).reshape(b * self.keys_per_sample)
        # Translate and snapshot the operands under one cache-lock hold.
        vals, scales, slots, scin = self.cache.translate_resolve(self.table_idx, keys)
        dev = self.cache.device
        slots_d = torch.from_numpy(slots).to(dev)
        scin_d = None if scin is None else torch.from_numpy(
            np.ascontiguousarray(scin, np.float32)).to(dev)
        dense_d = torch.from_numpy(dense).to(dev)
        with torch.inference_mode():
            return self._forward(vals, scales, slots_d, scin_d, dense_d)


class FusedMultiTableServer:
    """Serve a model that consumes one embedding block per table against an
    :class:`EmbeddingCache`: the host translates keys, the device gathers
    every table in one K1 launch and runs the model through ``assemble_fn``.

    - ``chunked=False``: ``assemble_fn(dense, embs)`` with ``embs`` the list
      of per-table [B, K_t, D_t] blocks.
    - ``chunked=True`` (DLRM): ``assemble_fn(dense, embs, order)``, where
      ``embs`` is an :class:`EmbParts` (one key per table, one dim) or the
      stacked [B, sum K_t, D] tensor, and ``order`` (or None) is the feature
      order the interaction sees (new position i holds original feature
      order[i])."""

    def __init__(self, params: InferenceParams, cache: EmbeddingCache, assemble_fn,
                 chunked: bool = False):
        self.params = params
        self.cache = cache
        self.assemble_fn = assemble_fn
        self.chunked = chunked
        self.keys_per_sample = list(params.maxnum_catfeature_query_per_table_per_sample)

    def _forward(self, vals, dscales, slots_cat, sb, scin_cat, cb, dense, batch, meta,
                 slices):
        """The device program over the packed lookup arguments: one K1
        launch for the groups the model reads as rows, then the model."""

        def gather(meta_):
            return lookup_program.lookup_groups(vals, dscales, slots_cat, scin_cat, meta_,
                                                sb, cb)

        if not self.chunked:
            gouts = gather(meta)
            return self.assemble_fn(dense, [
                gouts[g][start : start + cnt].reshape(batch, k, d)
                for (g, start, cnt, k, d) in slices
            ])
        chunk_plan = (
            self._chunk_plan(slices, {g: sb[g][1] - sb[g][0] for g in {s[0] for s in slices}})
            if all(k == 1 and d == slices[0][4] for (_, _, _, k, d) in slices)
            else None
        )
        order = None
        if chunk_plan is None:
            gouts = gather(meta)
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
            slots_oh = slots_cat[sb[g_oh][0]:sb[g_oh][1]].view(n_oh, stride)
            scales_oh = (None if cb[g_oh] is None
                         else scin_cat[cb[g_oh][0]:cb[g_oh][1]].view(n_oh, stride))
            gouts = gather(tuple(("skip",) if g == g_oh else m for g, m in enumerate(meta)))
            parts = [gouts[g].view(nblk, stride_, d) for (g, nblk, stride_) in rest_parts]
            if ord_l != tuple(range(len(fmap))):
                order = ord_l
            embs = EmbParts(parts, fmap_rest, batch,
                            oh=(vals[g_oh], slots_oh, scales_oh, members))
        else:
            gouts = gather(meta)
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
        dense_d = torch.from_numpy(dense).to(cache.device)
        with torch.inference_mode():
            return self._forward(vals, dscales, slots_cat, sb, scin_cat, cb, dense_d, b, meta,
                                 slices)


def _permute_columns(w: torch.Tensor, src: torch.Tensor, pad16: bool = False) -> torch.Tensor:
    """``w[:, src]`` for any dtype: an fp8 weight is permuted as its bytes.
    ``pad16``: rows zero-padded to a multiple of 16 columns, the layout K5
    reads with 16-byte copies (it ignores the columns past K)."""
    if w.dtype == torch.float8_e4m3fn:
        return w.view(torch.uint8)[:, src].contiguous().view(w.dtype)
    return k5_rows(w[:, src]) if pad16 else w[:, src].contiguous()


def make_dlrm_multi_server(params, cache, model) -> FusedMultiTableServer:
    """DLRM over many tables, one categorical feature per table (the Criteo
    layout). ``model`` is a :class:`~hugectr_backend_tpu_torch.models.dlrm.DLRM`,
    f32 or quantized (``quant_fmt``); it is moved to the cache's device.
    Models with K_t > 1 or mixed dims get the stacked tensor.

    For a reordered interaction the first top layer's input columns are
    permuted: the weight's, or ``kernel_q``'s for a quantized layer (its
    scales are per output column and do not move). The w8a8 result is exact
    under the permutation: the row absmax does not depend on the order, and
    the int32 sum is exact in any order. The permuted w8a8 weight's rows are
    padded to a multiple of 16 bytes (479 -> 480 at the Criteo widths), so
    that K5 streams it with 16-byte copies."""
    model = model.to(cache.device).eval()
    mixed = bool(params.use_mixed_precision)
    permuted: dict = {}

    def assemble(dense, emb, order=None):
        if order is None:
            return model(dense, emb, mixed_precision=mixed)
        w = permuted.get(order)
        if w is None:
            src = torch.from_numpy(interaction_permutation(order, model.bottom_widths[-1]))
            layer = model.top.layers[0]
            w0 = layer.kernel_q if model.quant_fmt else layer.weight
            w = permuted[order] = _permute_columns(w0, src.to(w0.device),
                                                   pad16=model.quant_fmt == "w8a8")
        return model(dense, emb, top_weight0=w, mixed_precision=mixed)

    return FusedMultiTableServer(params, cache, assemble, chunked=True)


def _model_server(params, cache, model, stack: bool) -> FusedMultiTableServer:
    """A non-chunked server of ``model`` (moved to the cache's device):
    ``stack`` concatenates the tables' blocks on the feature axis into one
    [B, sum K_t, D] (equal dims), else the model reads tables 0 and 1."""
    model = model.to(cache.device).eval()
    mixed = bool(params.use_mixed_precision)

    def assemble(dense, embs):
        if stack:
            return model(dense, torch.cat(embs, dim=1), mixed_precision=mixed)
        return model(dense, embs[0], embs[1], mixed_precision=mixed)

    return FusedMultiTableServer(params, cache, assemble)


def make_wdl_server(params, cache, model) -> FusedMultiTableServer:
    """WDL (:class:`~hugectr_backend_tpu_torch.models.wdl.WideAndDeep`):
    table 0 = wide (vecsize 1), table 1 = deep (the reference WDL demo: 2
    tables, vecsize [1, 16])."""
    return _model_server(params, cache, model, stack=False)


def make_dcn_server(params, cache, model) -> FusedMultiTableServer:
    """DCN-v2 (:class:`~hugectr_backend_tpu_torch.models.dcn.DCNv2`): all
    tables stacked on the feature axis (equal dims)."""
    return _model_server(params, cache, model, stack=True)


def make_deepfm_server(params, cache, model) -> FusedMultiTableServer:
    """DeepFM (:class:`~hugectr_backend_tpu_torch.models.deepfm.DeepFM`):
    table 0 = first-order weights (vecsize 1), table 1 = the second-order
    and deep embeddings."""
    return _model_server(params, cache, model, stack=False)


def make_xdeepfm_server(params, cache, model) -> FusedMultiTableServer:
    """xDeepFM (:class:`~hugectr_backend_tpu_torch.models.xdeepfm.XDeepFM`):
    all tables stacked on the feature axis (equal dims); CIN and the deep
    MLP share them."""
    return _model_server(params, cache, model, stack=True)


def make_ncf_server(params, cache, model) -> FusedMultiTableServer:
    """NCF / NeuMF (:class:`~hugectr_backend_tpu_torch.models.ncf.NCF`):
    table 0 = users, table 1 = items, one key each."""
    return _model_server(params, cache, model, stack=False)


def make_mmoe_server(params, cache, model) -> FusedMultiTableServer:
    """MMoE (:class:`~hugectr_backend_tpu_torch.models.mmoe.MMoE`): all
    tables stacked on the feature axis (equal dims); logits [B, num_tasks]."""
    return _model_server(params, cache, model, stack=True)
