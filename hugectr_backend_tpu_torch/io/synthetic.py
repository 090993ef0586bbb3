"""Synthetic table / batch generators for tests and benchmarks.

Serves the role of the reference CI's external demo data (the reference tests
against cluster-NFS `dlrm.py` clients and `perf_analyzer --shape KEYS:26`,
reference .gitlab-ci.yml:58-88) but self-contained: deterministic tables whose
vectors are a known function of the key, so lookups are verifiable without
golden files.
"""

from __future__ import annotations

import numpy as np

from hugectr_backend_tpu_torch.io.sparse_model import SparseModelTable


def make_synthetic_table(
    num_rows: int,
    dim: int,
    seed: int = 0,
    key_space: int | None = None,
    deterministic_fn: bool = True,
) -> SparseModelTable:
    """Create a table with distinct int64 keys and verifiable vectors.

    With ``deterministic_fn=True`` (the default), row vectors follow
    ``vec[k, j] = sin(k * 0.001 + j * 0.1)`` — any (key, position) pair can be
    recomputed by a test without storing the table. This mirrors the known
    key->vector-shift check used by the reference acceptance notebooks
    (reference samples/.../hps2predict.py).
    """
    rng = np.random.default_rng(seed)
    space = key_space or max(num_rows * 4, 1)
    keys = rng.choice(space, size=num_rows, replace=False).astype(np.int64)
    if deterministic_fn:
        vectors = expected_vector(keys, dim)
    else:
        vectors = rng.standard_normal((num_rows, dim)).astype(np.float32)
    return SparseModelTable(keys=keys, vectors=vectors)


def expected_vector(keys: np.ndarray, dim: int) -> np.ndarray:
    """The deterministic key->vector function used by `make_synthetic_table`."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1, 1).astype(np.float64)
    j = np.arange(dim, dtype=np.float64).reshape(1, -1)
    return np.sin(keys * 0.001 + j * 0.1).astype(np.float32)


def make_criteo_like_batch(
    batch_size: int,
    tables_rows: list[int],
    keys_per_sample_per_table: list[int],
    table_keys: list[np.ndarray] | None = None,
    seed: int = 0,
    alpha: float = 1.05,
):
    """Synthesize a Criteo-style request: KEYS (flat int64) + NUMKEYS (int32).

    Request format matches the reference wire contract
    (reference docs/architecture.md:220-231): KEYS is the concatenation over
    tables of ``batch * keys_per_sample`` keys; NUMKEYS holds the per-table
    total key counts. Keys are drawn Zipf-like (exponent ``alpha``) to model
    the power-law access skew that the reference's hot cache exploits
    (reference docs/architecture.md:49-50).
    """
    if table_keys is None:
        raise ValueError(
            "table_keys is required: make_synthetic_table draws keys from a "
            "random id space, so rank indices are NOT valid keys — passing "
            "ranks directly would make ~75% of lookups miss while claiming "
            "to model a hot-cache workload"
        )
    rng = np.random.default_rng(seed)
    keys_chunks = []
    num_keys = []
    for t, rows in enumerate(tables_rows):
        per = keys_per_sample_per_table[t]
        n = batch_size * per
        # Zipf-ish rank sampling bounded to the table size.
        ranks = rng.zipf(alpha, size=n) % max(rows, 1)
        chunk = table_keys[t][ranks]
        keys_chunks.append(chunk.astype(np.int64))
        num_keys.append(n)
    return np.concatenate(keys_chunks), np.asarray(num_keys, dtype=np.int32)
