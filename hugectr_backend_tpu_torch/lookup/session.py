"""Lookup session: the per-(model, device) query object.

Port of the JAX package's lookup/session.py (the reference's
``LookupSessionBase`` contract):

    LookupSession.create(params, embedding_cache)
    session.lookup(keys_per_table, num_keys_per_table) -> per-table vectors

Sessions are thread-safe and many sessions share one :class:`EmbeddingCache`.
The request wire format is preserved: ``KEYS`` is the flat int64
concatenation over tables of each sample's keys; ``NUMKEYS`` is the per-table
total key count (``lookup_from_request``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache
from hugectr_backend_tpu_torch.config.params import InferenceParams


class LookupSession:
    def __init__(self, params: InferenceParams, cache: EmbeddingCache):
        self.params = params
        self.cache = cache

    @classmethod
    def create(cls, params: InferenceParams, embedding_cache: EmbeddingCache):
        return cls(params, embedding_cache)

    def _live_keys(self, keys_per_table, num_keys_per_table):
        if len(keys_per_table) != self.cache.num_tables:
            raise ValueError(
                f"got {len(keys_per_table)} key arrays for "
                f"{self.cache.num_tables} tables"
            )
        if num_keys_per_table is None:
            return keys_per_table
        return [np.asarray(k).reshape(-1)[: int(n)]
                for k, n in zip(keys_per_table, num_keys_per_table)]

    def lookup(
        self,
        keys_per_table: Sequence[np.ndarray],
        num_keys_per_table: Optional[Sequence[int]] = None,
    ) -> list[torch.Tensor]:
        """Per-table gather + dequant with miss-merge and default-on-miss.

        ``keys_per_table[t]`` may be over-allocated; ``num_keys_per_table[t]``
        bounds the live prefix. -> per-table f32 tensors [num_keys_t,
        vecsize_t] on the cache's device."""
        return self.cache.lookup(self._live_keys(keys_per_table, num_keys_per_table))

    def lookup_numpy(self, keys_per_table, num_keys_per_table=None) -> list[np.ndarray]:
        """:meth:`lookup`, copied to host numpy arrays."""
        return [o.cpu().numpy() for o in self.lookup(keys_per_table, num_keys_per_table)]

    def lookup_flat(self, keys_per_table, num_keys_per_table=None,
                    pad_counts=None) -> torch.Tensor:
        """Single flat f32 OUTPUT0 vector (table-major). ``pad_counts[t]``
        pads table t's run with default-row slots."""
        return self.cache.lookup_flat(
            self._live_keys(keys_per_table, num_keys_per_table),
            pad_counts=pad_counts)

    # ---------------------------------------------------------- wire format

    def split_request(self, flat_keys: np.ndarray, num_keys: np.ndarray):
        """Split the flat KEYS buffer into per-table key arrays using NUMKEYS."""
        flat_keys = np.asarray(flat_keys, dtype=np.int64).reshape(-1)
        num_keys = np.asarray(num_keys, dtype=np.int64).reshape(-1)
        if num_keys.shape[0] != self.cache.num_tables:
            raise ValueError(
                f"NUMKEYS has {num_keys.shape[0]} entries, expected "
                f"{self.cache.num_tables}"
            )
        if (num_keys < 0).any():
            raise ValueError(f"NUMKEYS entries must be >= 0, got "
                             f"{num_keys.tolist()}")
        total = int(num_keys.sum())
        if total != flat_keys.shape[0]:
            raise ValueError(
                f"KEYS holds {flat_keys.shape[0]} keys but NUMKEYS sums to {total}"
            )
        offsets = np.concatenate([[0], np.cumsum(num_keys)]).astype(np.int64)
        return [flat_keys[offsets[t] : offsets[t + 1]] for t in range(len(num_keys))]

    def lookup_from_request(self, flat_keys: np.ndarray, num_keys: np.ndarray) -> np.ndarray:
        """KEYS + NUMKEYS in, flat float32 numpy out (sum_t numkeys_t *
        vecsize_t floats)."""
        out = self.cache.lookup_flat(self.split_request(flat_keys, num_keys))
        return out.cpu().numpy()
