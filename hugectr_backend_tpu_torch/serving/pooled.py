"""Variable-length multi-hot lookups with fused pooling (DIN-style).

Port of the JAX package's serving/pooled.py (BASELINE config 4:
"Sequence recsys (DIN-style) with variable-length multi-hot lookups and
fused pooling"). Keys arrive padded to S per sample with a length vector
``seq_len`` masking the live prefix; K1 gathers and dequantizes the
[B * S] rows (``ops.dequant_gather.gather_dequant``) and the masked sum or
mean runs on the same device, so the [B, S, D] block never leaves it.
Padding slots point at the default row; the mask makes ``mean`` right and
keeps nonzero default values out of the pool.

:class:`FusedDinServer` serves DIN and BST: one K1 launch for the target
table, one for the sequence table (the JAX package's two gathers), then the
model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache
from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant


def _pooled_gather(values, scales, slots, seq_len, batch: int, max_len: int,
                   mode: str = "sum", scin=None) -> torch.Tensor:
    """slots [B * S] -> pooled [B, D]: K1 (device ``scales`` or the
    host-gathered per-key ``scin``, never both), then the masked sum, or the
    mean over ``max(seq_len, 1)`` live rows."""
    flat = gather_dequant(values, scales, slots, scin)  # [B * S, D]
    emb = flat.view(batch, max_len, flat.shape[-1])
    mask = (torch.arange(max_len, device=emb.device)[None, :] < seq_len[:, None]).to(emb.dtype)
    summed = (emb * mask[..., None]).sum(dim=1)
    if mode == "mean":
        return summed / torch.clamp(seq_len.to(summed.dtype), min=1.0)[:, None]
    return summed


def _to(a: Optional[np.ndarray], dtype, device) -> Optional[torch.Tensor]:
    """A host array as a tensor of ``dtype`` on ``device`` (None stays None)."""
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def pooled_lookup(cache: EmbeddingCache, table_idx: int, keys, seq_len=None,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot pooled lookup: keys [B, S] (padded), seq_len [B] -> [B, D]
    f32 on the cache's device. ``seq_len=None``: all S keys are live. Padding
    positions may hold any key; unknown keys hit the default row."""
    if mode not in ("sum", "mean"):
        # An unknown mode must not pool as "sum": plausible wrong embeddings
        # would flow into the dense net.
        raise ValueError(f"unknown pooling mode {mode!r} (want sum|mean)")
    keys = np.asarray(keys, dtype=np.int64)
    if keys.ndim != 2:
        raise ValueError(f"keys must be [batch, max_len], got {keys.shape}")
    b, s = keys.shape
    if seq_len is None:
        seq_len = np.full(b, s, np.int32)
    # Translate and snapshot under one cache-lock hold.
    vals, dev_scales, slots, scin = cache.translate_resolve(table_idx, keys.reshape(-1))
    dev = cache.device
    with torch.inference_mode():
        return _pooled_gather(vals, dev_scales, _to(slots, np.int32, dev),
                              _to(seq_len, np.int32, dev), b, s, mode,
                              scin=_to(scin, np.float32, dev))


class FusedDinServer:
    """DIN (or BST) serving: the target lookup, the sequence lookup and the
    model on one device. ``model`` takes ``(dense, target [B, D], seq
    [B, S, D], seq_len [B])`` (:class:`~hugectr_backend_tpu_torch.models.din.DIN`,
    :class:`~hugectr_backend_tpu_torch.models.bst.BST`); it is moved to the
    cache's device."""

    def __init__(self, params, cache: EmbeddingCache, model, target_table: int = 0,
                 seq_table: int = 1):
        self.params = params
        self.cache = cache
        self.model = model.to(cache.device).eval()
        self.target_table = target_table
        self.seq_table = seq_table
        self.max_seq = params.maxnum_catfeature_query_per_table_per_sample[seq_table]

    def predict(self, target_keys, seq_keys, seq_len, dense) -> torch.Tensor:
        """target_keys [B]; seq_keys [B, S] padded; seq_len [B]; dense
        [B, Nd]. -> logits [B] on the cache's device."""
        dense = np.asarray(dense, dtype=np.float32)
        b = dense.shape[0]
        seq_keys = np.asarray(seq_keys, dtype=np.int64).reshape(b, -1)
        s = seq_keys.shape[1]
        # Each table's translation pairs with its operand snapshot under one
        # lock hold; the two tables need not share one.
        tv, ts, tslots, tscin = self.cache.translate_resolve(
            self.target_table, np.asarray(target_keys, np.int64).reshape(-1))
        sv, ss, sslots, sscin = self.cache.translate_resolve(self.seq_table, seq_keys.reshape(-1))
        dev = self.cache.device
        with torch.inference_mode():
            target = gather_dequant(tv, ts, _to(tslots, np.int32, dev),
                                    _to(tscin, np.float32, dev))
            seq = gather_dequant(sv, ss, _to(sslots, np.int32, dev), _to(sscin, np.float32, dev))
            return self.model(_to(dense, np.float32, dev), target, seq.view(b, s, -1),
                              _to(seq_len, np.int32, dev))
