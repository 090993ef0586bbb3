"""Key-value tier interface shared by the DRAM and SSD tiers.

Plays the role of the reference's ``DatabaseBackend`` contract behind
``HierParameterServerBase`` (volatile + persistent DBs, reference
docs/hierarchical_parameter_server.md:400-573): bulk insert / fetch / evict of
(int64 key -> float32 vector) pairs, namespaced by a table tag.

Table tags follow the reference's naming convention so ``update_filters``
regexes written for HugeCTR keep working: ``hps_et.<model>.<table_name>``
(reference docs/hierarchical_parameter_server.md update-filter examples).
"""

from __future__ import annotations

import abc
import numpy as np


def table_tag(model_name: str, table_name: str) -> str:
    return f"hps_et.{model_name}.{table_name}"


class KVTier(abc.ABC):
    """Bulk key->vector store. All methods take/return numpy arrays."""

    @abc.abstractmethod
    def create_table(self, tag: str, dim: int) -> None: ...

    @abc.abstractmethod
    def drop_table(self, tag: str) -> None: ...

    @abc.abstractmethod
    def tables(self) -> list[str]: ...

    @abc.abstractmethod
    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        """Upsert pairs; returns number of rows written."""

    @abc.abstractmethod
    def query(self, tag: str, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (vectors [n, dim] float32, found [n] bool). Missing rows are
        zero-filled; the caller applies default-value semantics."""

    @abc.abstractmethod
    def size(self, tag: str) -> int: ...

    @abc.abstractmethod
    def keys(self, tag: str) -> np.ndarray: ...

    def evict(self, tag: str, keys: np.ndarray) -> int:
        raise NotImplementedError(f"{type(self).__name__} does not support evict")

    def clear(self) -> None:
        for t in list(self.tables()):
            self.drop_table(t)
