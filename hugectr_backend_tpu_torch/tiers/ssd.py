"""Local-SSD persistent tier: log-structured key->vector store.

Port of the JAX package's tiers/ssd.py; the files on disk are the same byte
for byte, so either package opens a directory the other wrote. It replaces
the reference's RocksDB persistent database
(reference docs/hierarchical_parameter_server.md:548-573): durable full copy
of every embedding table on local disk, bulk query/insert, column-family-like
separation per table (one subdirectory per table tag, mirroring the
reference's column-family-per-table, README.md:210).

Layout per table:
    <path>/<tag>/data.log   : append-only records [int64 key][float32 x dim]
    <path>/<tag>/meta.json  : {"dim": D}
    <path>/<tag>/index.npz  : sidecar index {keys_sorted, rows, watermark}

Scale design (terabyte-scale tables):

- The key index is VECTORIZED: sorted key array + per-key newest-record row,
  looked up via np.searchsorted — no Python per-key loop anywhere, on bulk
  loads OR small-batch update storms. Recent inserts land as raw array
  fragments (O(1) append per batch, an LSM-style memtable), consolidated
  into a sorted overlay every ``PEND_CONSOLIDATE`` keys and folded into the
  main index past ``OVERLAY_FLUSH`` keys.
- The index is PERSISTED as a sidecar with a record watermark: reopening a
  table loads the sidecar and tail-scans only records written after the
  watermark (a crash between appends and sidecar writes costs a bounded
  vectorized tail scan, not a full-log rescan).
- Reads SNAPSHOT under the lock (index arrays + a memmap of the current
  log) and do the bulk record gather OUTSIDE it — records are immutable
  once written, and ``os.replace`` during compaction keeps a reader's
  already-open memmap valid (old inode), so queries never serialize behind
  each other or behind compaction's file swap.
- Compaction (drop superseded records) is vectorized and runs from a
  BACKGROUND thread when a table's dead-record ratio crosses
  ``COMPACT_DEAD_RATIO``; the stop-the-world window is only the tmp-file
  swap + index rebuild.

The async DRAM promotion hook lives in HierParameterServer.prefetch().
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np

from hugectr_backend_tpu_torch.config.params import PersistentDatabaseParams
from hugectr_backend_tpu_torch.tiers.base import KVTier

OVERLAY_FLUSH = 65536
PEND_CONSOLIDATE = 8192
COMPACT_DEAD_RATIO = 0.5
COMPACT_MIN_RECORDS = 10_000


def _merge_many(ks_list, rs_list):
    """Merge N (keys, rows) index fragments; for duplicate keys the larger
    row (newer record) wins. Fully vectorized."""
    allk = np.concatenate(ks_list)
    allr = np.concatenate(rs_list)
    order = np.lexsort((allr, allk))
    ks, rs = allk[order], allr[order]
    last = np.concatenate([ks[1:] != ks[:-1], [True]]) if ks.size else np.zeros(0, bool)
    return ks[last], rs[last]


def _merge_newest(k1, r1, k2, r2):
    return _merge_many([k1, k2], [r1, r2])


def _index_from_keys(keys: np.ndarray):
    """Newest-wins index of a raw log key column. Vectorized."""
    n = keys.shape[0]
    rev = keys[::-1]
    uk, first = np.unique(rev, return_index=True)
    return uk, (n - 1 - first).astype(np.int64)


class _TableLog:
    def __init__(self, root: Path, tag: str, dim: int, read_only: bool):
        self.dir = root / tag.replace("/", "_")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.data_path = self.dir / "data.log"
        self.meta_path = self.dir / "meta.json"
        self.index_path = self.dir / "index.npz"
        self.read_only = read_only
        self.lock = threading.Lock()
        if self.meta_path.exists():
            meta = json.loads(self.meta_path.read_text())
            if meta["dim"] != dim and dim:
                raise ValueError(
                    f"table {tag}: on-disk dim {meta['dim']} != requested {dim}"
                )
            self.dim = int(meta["dim"])
        else:
            if read_only:
                raise FileNotFoundError(f"read-only SSD tier: table {tag} absent")
            self.dim = dim
            self.meta_path.write_text(json.dumps({"dim": dim}))
        self.record_bytes = 8 + 4 * self.dim
        # Vectorized main index + bounded memtable overlay. The overlay is
        # itself vectorized (sorted arrays + raw pending fragments appended
        # O(1) per insert and consolidated in bulk) — a small-batch update
        # storm never pays a Python per-key loop.
        self._ksorted = np.zeros(0, np.int64)
        self._krows = np.zeros(0, np.int64)
        self._okeys = np.zeros(0, np.int64)
        self._orows = np.zeros(0, np.int64)
        self._pend: list[tuple[np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._open()

    # ----------------------------------------------------------- open/index

    def _log_records(self) -> int:
        if not self.data_path.exists():
            self.data_path.touch()
            return 0
        return self.data_path.stat().st_size // self.record_bytes

    def _log_keys(self, start: int, stop: int) -> np.ndarray:
        if stop <= start:
            return np.zeros(0, np.int64)
        raw = np.memmap(
            self.data_path, dtype=np.uint8, mode="r",
            shape=(stop * self.record_bytes,),
        )
        recs = raw.reshape(stop, self.record_bytes)[start:]
        return recs[:, :8].copy().view(np.int64).reshape(-1)

    def _open(self):
        """Load the sidecar index and tail-scan anything past its watermark
        (no full-log rescan on a clean reopen)."""
        n = self._log_records()
        watermark = 0
        if self.index_path.exists():
            try:
                with np.load(self.index_path) as z:
                    watermark = int(z["watermark"])
                    if watermark <= n:
                        self._ksorted = z["keys"].astype(np.int64)
                        self._krows = z["rows"].astype(np.int64)
                    else:  # truncated/corrupt log vs index: full rescan
                        watermark = 0
            except Exception:
                watermark = 0
        if watermark < n:
            tail_keys = self._log_keys(watermark, n)
            tk, tr = _index_from_keys(tail_keys)
            self._ksorted, self._krows = _merge_newest(
                self._ksorted, self._krows, tk, tr + watermark
            )
        self._indexed = n

    def _save_sidecar(self):
        tmp = self.dir / "index.tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, keys=self._ksorted, rows=self._krows,
                     watermark=np.int64(self._indexed))
        os.replace(tmp, self.index_path)

    def _consolidate_locked(self):
        """Fold the raw pending fragments into the sorted overlay arrays."""
        if not self._pend:
            return
        self._okeys, self._orows = _merge_many(
            [self._okeys] + [k for k, _ in self._pend],
            [self._orows] + [r for _, r in self._pend],
        )
        self._pend = []
        self._pend_n = 0

    def _overlay_size_locked(self) -> int:
        return int(self._okeys.size) + self._pend_n

    def _flush_overlay_locked(self):
        self._consolidate_locked()
        if not self._okeys.size:
            return
        self._ksorted, self._krows = _merge_newest(
            self._ksorted, self._krows, self._okeys, self._orows
        )
        self._okeys = np.zeros(0, np.int64)
        self._orows = np.zeros(0, np.int64)
        self._save_sidecar()

    # ---------------------------------------------------------------- write

    def insert(self, keys: np.ndarray, vectors: np.ndarray) -> int:
        if self.read_only:
            raise PermissionError("SSD tier opened read_only")
        keys = np.asarray(keys, dtype="<i8").reshape(-1)
        vectors = np.asarray(vectors, dtype="<f4").reshape(keys.shape[0], self.dim)
        rec = np.empty((keys.shape[0], self.record_bytes), dtype=np.uint8)
        rec[:, :8] = keys.view(np.uint8).reshape(-1, 8)
        rec[:, 8:] = vectors.view(np.uint8).reshape(-1, 4 * self.dim)
        with self.lock:
            base = self._log_records()
            with open(self.data_path, "ab") as f:
                f.write(rec.tobytes())
            if keys.shape[0] > OVERLAY_FLUSH:
                nk, nr = _index_from_keys(keys)
                self._ksorted, self._krows = _merge_newest(
                    self._ksorted, self._krows, nk, nr + base
                )
            else:
                # O(1) append; consolidation into the sorted overlay is
                # amortized over many small batches (no per-key work).
                self._pend.append(
                    (keys, base + np.arange(keys.shape[0], dtype=np.int64))
                )
                self._pend_n += keys.shape[0]
                if self._pend_n >= PEND_CONSOLIDATE:
                    self._consolidate_locked()
            self._indexed = base + keys.shape[0]
            if self._overlay_size_locked() > OVERLAY_FLUSH:
                self._flush_overlay_locked()
        return int(keys.shape[0])

    # ----------------------------------------------------------------- read

    def _lookup_rows(self, keys: np.ndarray, ksorted, krows, okeys, orows):
        rows = np.full(keys.shape[0], -1, np.int64)
        if ksorted.size:
            pos = np.searchsorted(ksorted, keys)
            pos_c = np.minimum(pos, ksorted.size - 1)
            hit = ksorted[pos_c] == keys
            rows[hit] = krows[pos_c[hit]]
        if okeys.size:
            pos = np.searchsorted(okeys, keys)
            pos_c = np.minimum(pos, okeys.size - 1)
            hit = okeys[pos_c] == keys
            # Rows are append-log positions, so the newest record is simply
            # the max row: a bulk insert can land a key in the main index at
            # a HIGHER row than a stale overlay entry (bulk inserts bypass
            # the overlay), so neither side unconditionally wins.
            rows[hit] = np.maximum(rows[hit], orows[pos_c[hit]])
        return rows

    def delete(self, keys: np.ndarray) -> int:
        """Drop keys from the index (their log records become dead and are
        reclaimed by compaction). Persisted via the sidecar: a reopen does
        not resurrect them (records before the watermark are never
        rescanned). -> number of distinct keys removed."""
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        if keys.size == 0:
            return 0
        with self.lock:
            # Flush the overlay FIRST: the sidecar's watermark invariant is
            # "persisted index covers every record below the watermark",
            # and saving mid-overlay would silently drop live entries on
            # the next reopen.
            self._flush_overlay_locked()
            before = self._ksorted.size
            if before:
                keep = ~np.isin(self._ksorted, keys)
                self._ksorted = self._ksorted[keep]
                self._krows = self._krows[keep]
            removed = before - self._ksorted.size
            if removed:
                self._save_sidecar()
        return int(removed)

    def query(self, keys: np.ndarray):
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        out = np.zeros((keys.shape[0], self.dim), dtype=np.float32)
        found = np.zeros(keys.shape[0], dtype=bool)
        # Snapshot under the lock; bulk-read OUTSIDE it (records are
        # immutable; a concurrent compaction's os.replace leaves this
        # memmap on the old inode).
        with self.lock:
            n = self._log_records()
            if n == 0:
                return out, found
            recs = np.memmap(
                self.data_path, dtype=np.uint8, mode="r",
                shape=(n * self.record_bytes,),
            ).reshape(n, self.record_bytes)
            self._consolidate_locked()
            ksorted, krows = self._ksorted, self._krows
            okeys, orows = self._okeys, self._orows
        rows = self._lookup_rows(keys, ksorted, krows, okeys, orows)
        hit = (rows >= 0) & (rows < n)
        if hit.any():
            sel = recs[rows[hit], 8:]
            out[hit] = sel.copy().view("<f4").reshape(-1, self.dim)
            found[hit] = True
        return out, found

    # ----------------------------------------------------------- maintenance

    def live_and_total(self) -> tuple[int, int]:
        with self.lock:
            total = self._log_records()
            live = self._size_locked()
        return live, total

    def _size_locked(self) -> int:
        self._consolidate_locked()
        if not self._okeys.size:
            return int(self._ksorted.size)
        if not self._ksorted.size:
            return int(self._okeys.size)
        pos = np.searchsorted(self._ksorted, self._okeys)
        pos_c = np.minimum(pos, self._ksorted.size - 1)
        new = int((self._ksorted[pos_c] != self._okeys).sum())
        return int(self._ksorted.size) + new

    def compact(self):
        """Rewrite the log keeping only live records (vectorized; the
        stop-the-world window covers the rewrite + index rebuild)."""
        with self.lock:
            self._flush_overlay_locked()
            n = self._log_records()
            if n == 0 or n == self._ksorted.size:
                return
            recs = np.memmap(
                self.data_path, dtype=np.uint8, mode="r",
                shape=(n * self.record_bytes,),
            ).reshape(n, self.record_bytes)
            live = np.sort(self._krows)
            kept = recs[live].copy()
            del recs
            tmp = self.data_path.with_suffix(".log.tmp")
            tmp.write_bytes(kept.tobytes())
            os.replace(tmp, self.data_path)
            # Rows renumber to the kept order; keys stay sorted by key, and
            # kept is ordered by OLD row, so recompute the mapping.
            order = np.argsort(self._krows)
            self._krows = np.empty_like(self._krows)
            self._krows[order] = np.arange(live.size)
            self._indexed = live.size
            self._save_sidecar()


class SsdKVTier(KVTier):
    def __init__(self, params: PersistentDatabaseParams | None = None,
                 path: str | None = None,
                 background_compaction: bool = True,
                 compact_interval_s: float = 30.0):
        self.params = params or PersistentDatabaseParams()
        self.root = Path(path or self.params.path)
        self.root.mkdir(parents=True, exist_ok=True)
        self._logs: dict[str, _TableLog] = {}
        self._lock = threading.Lock()
        # Reopen existing tables (durable across restarts, like RocksDB).
        for d in self.root.iterdir():
            if (d / "meta.json").exists():
                tag = d.name
                self._logs[tag] = _TableLog(self.root, tag, 0, self.params.read_only)
        self._stop = threading.Event()
        self._compactor: threading.Thread | None = None
        if background_compaction and not self.params.read_only:
            self._compact_interval = compact_interval_s
            self._compactor = threading.Thread(
                target=self._compact_loop, daemon=True, name="hps-ssd-compact"
            )
            self._compactor.start()

    def _compact_loop(self):
        while not self._stop.wait(self._compact_interval):
            self.maybe_compact()

    def maybe_compact(self) -> int:
        """Compact any table whose dead-record ratio crossed the threshold.
        Returns the number of tables compacted."""
        done = 0
        for log in list(self._logs.values()):
            live, total = log.live_and_total()
            if total >= COMPACT_MIN_RECORDS and live < total * (
                1.0 - COMPACT_DEAD_RATIO
            ):
                log.compact()
                done += 1
        return done

    def close(self):
        self._stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout=5)

    def _norm(self, tag: str) -> str:
        return tag.replace("/", "_")

    def create_table(self, tag: str, dim: int) -> None:
        tag = self._norm(tag)
        with self._lock:
            if tag not in self._logs:
                self._logs[tag] = _TableLog(self.root, tag, dim, self.params.read_only)

    def drop_table(self, tag: str) -> None:
        tag = self._norm(tag)
        with self._lock:
            log = self._logs.pop(tag, None)
        if log is not None:
            import shutil

            shutil.rmtree(log.dir, ignore_errors=True)

    def tables(self) -> list[str]:
        return list(self._logs.keys())

    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        tag = self._norm(tag)
        if tag not in self._logs:
            self.create_table(tag, int(np.asarray(vectors).reshape(len(keys), -1).shape[1]))
        return self._logs[tag].insert(keys, vectors)

    def query(self, tag: str, keys: np.ndarray):
        return self._logs[self._norm(tag)].query(keys)

    def evict(self, tag: str, keys: np.ndarray) -> int:
        return self._logs[self._norm(tag)].delete(keys)

    def size(self, tag: str) -> int:
        log = self._logs[self._norm(tag)]
        with log.lock:
            return log._size_locked()

    def keys(self, tag: str) -> np.ndarray:
        log = self._logs[self._norm(tag)]
        with log.lock:
            log._consolidate_locked()
            if not log._okeys.size:
                return log._ksorted.copy()
            return np.union1d(log._ksorted, log._okeys)

    def compact(self) -> None:
        for log in self._logs.values():
            log.compact()
