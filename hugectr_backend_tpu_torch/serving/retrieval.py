"""Retrieval serving: user tower, scoring of the whole corpus, top-k.

Port of the JAX package's serving/retrieval.py. Per call: K1 gathers the
user rows, the user tower gives the queries [B, D], one product scores them
against every resident row of the item table (the corpus [capacity, D],
the default row excluded), the per-row dequant scales multiply the score
columns after the product, and the top k of each row come back with their
item keys. Only the [B, k] winners travel to the host.

Scoring precision, as in the JAX package: an f32 corpus scores in f32; an
int8, fp8 or bf16 corpus with bf16 operands and f32 sums. Its values are
exact in bf16, so the corpus is held as f32 (one copy per snapshot of the
item table) and the queries are rounded to bf16: the f32 product of two
bf16 values is exact, and only the sums round. (A bf16 ``torch.matmul``
would round its output to bf16 as well.) TF32 must be off, PyTorch's
default, for f32 products to be f32. A tower with ``compute_dtype`` bf16
gives bf16 queries: they are upcast exactly, so an f32 corpus scores them
in f32, as the JAX package's ``dot_general`` of bf16 and f32 operands does.

:func:`top_k` keeps ``lax.top_k``'s order: among equal scores the lower
corpus index comes first (an int8 corpus with repeated rows gives equal
scores).
"""

from __future__ import annotations

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
from hugectr_backend_tpu_torch.serving.pooled import _to

_LOW = (1 << 32) - 1


def top_k(scores: torch.Tensor, k: int, rows: int = 128):
    """The k largest entries of each row of ``scores`` [B, N] f32, in
    descending order, the lower index first among equal scores (the order of
    ``lax.top_k``). -> (values [B, k] f32, indices [B, k] int64).

    ``torch.topk`` promises no order among ties, so it runs on int64 keys:
    the f32 score's bits made order-preserving in the high word, the
    inverted index in the low word (every key distinct). As in ``lax.top_k``,
    -0.0 ranks below +0.0. ``rows`` rows at a time bound the keys' memory."""
    b, n = scores.shape
    if n > _LOW:
        raise ValueError(f"top_k: {n} columns do not fit the key's low word")
    low = _LOW - torch.arange(n, device=scores.device, dtype=torch.int64)
    out = []
    for r in range(0, b, rows):
        bits = scores[r : r + rows].view(torch.int32)
        # A negative float's magnitude bits run the wrong way: flip them.
        okey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
        top = torch.topk(okey * (1 << 32) + low, k, dim=1).values
        out.append(_LOW - (top & _LOW))
    idx = torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64,
                                                 device=scores.device)
    return torch.gather(scores, 1, idx), idx


class RetrievalServer:
    """Serve two-tower retrieval against an :class:`EmbeddingCache`.

    ``user_table`` feeds the query tower ``model``
    (:class:`~hugectr_backend_tpu_torch.models.two_tower.TwoTowerUser`-shaped:
    ``model(dense, user_emb [B, K_u, D_u]) -> [B, D]``, D the item dim; it is
    moved to the cache's device); ``item_table`` is the corpus, every
    resident row a candidate. Refused, as in the JAX package: a cache other
    than ``static`` (a dynamic cache reassigns slots, and a scored row would
    carry another key), an int4 (nibble-packed) item table, and ``k``
    outside [1, corpus size]."""

    def __init__(self, params, cache, model, user_table: int = 0, item_table: int = 1,
                 k: int = 100):
        if cache.num_tables <= max(user_table, item_table):
            raise ValueError("cache does not hold the requested tables")
        cache_type = getattr(params.embedding_cache_type, "value", params.embedding_cache_type)
        if str(cache_type) != "static":
            raise ValueError(
                "retrieval requires embedding_cache_type 'static' (the corpus row -> key "
                f"mapping must be stable), got {cache_type}")
        it = cache.tables[item_table]
        if it.values.dtype == torch.uint8:
            raise ValueError("retrieval corpus cannot be int4 nibble-packed; serve the "
                             "item table at quant_bits 8/16/32")
        self.params = params
        self.cache = cache
        self.model = model.to(cache.device).eval()
        self.user_table = user_table
        self.item_table = item_table
        self.k = int(k)
        if not 1 <= self.k <= it.capacity:
            raise ValueError(f"k={self.k} must be in [1, corpus size {it.capacity}]")
        self.keys_per_sample = params.maxnum_catfeature_query_per_table_per_sample[user_table]
        self._item_snap = None

    def _corpus(self):
        """-> (corpus [n, D] f32, scales [n] or None, n, sorted item keys,
        whether the queries round to bf16), memoized on the identity of the
        item table's raw values tensor (a refresh or update replaces it)."""
        cache = self.cache
        with cache._lock:
            it = cache.tables[self.item_table]
            arena = getattr(it, "arena", None)
            raw = arena.values if arena is not None else it.values
            snap = self._item_snap
            if snap is None or snap[0] is not raw:
                n = int(it.capacity)
                iv = it.values[:n]
                sc = it.scales
                snap = self._item_snap = (raw, iv.float(), None if sc is None else sc[:n], n,
                                          it.index.sorted_keys, iv.dtype != torch.float32)
        return snap[1:]

    def retrieve(self, user_keys, dense, k=None):
        """-> (item keys [B, k] int64, scores [B, k] f32), numpy.
        ``user_keys`` [B, K_u] or flat; ``dense`` [B, Nd] (zero width
        allowed)."""
        k = self.k if k is None else int(k)
        dense = np.asarray(dense, dtype=np.float32)
        b = dense.shape[0]
        user_keys = np.asarray(user_keys, np.int64).reshape(b * self.keys_per_sample)
        uvals, uscales, uslots, uscin = self.cache.translate_resolve(self.user_table, user_keys)
        corpus, iscales, n_items, item_keys, bf16 = self._corpus()
        if not 1 <= k <= n_items:
            raise ValueError(f"k={k} must be in [1, corpus size {n_items}]")
        dev = self.cache.device
        with torch.inference_mode():
            urows = gather_dequant(uvals, uscales, _to(uslots, np.int32, dev),
                                   _to(uscin, np.float32, dev))
            q = self.model(_to(dense, np.float32, dev),
                           urows.view(b, -1, urows.shape[-1])).float()
            if bf16:
                q = q.to(torch.bfloat16).float()
            scores = torch.matmul(q, corpus.T)
            if iscales is not None:
                scores = scores * iscales[None, :]
            vals, idx = top_k(scores, k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return item_keys[idx], vals
