"""Online update ingestion: the trainer -> inference parameter stream.

Port of the JAX package's update/source.py (the same wire bytes and files).

Mirrors the reference's Kafka-based update pipeline (reference README.md:
213-218; docs/hierarchical_parameter_server.md:575-646):

- **Message Producer API** — used on the training side to publish
  (table, keys, vectors) tuples;
- **Message Source API** — used on the inference side: a consumer thread
  pulls updates and applies them to the DRAM/SSD tiers, after which the HBM
  caches pick them up on their refresh cycle (reference: "HugeCTR backend
  updates the GPU embedding cache asynchronously").

Transport implementations:
- ``FileQueueSource``: durable directory-based queue (one subdirectory per
  table tag, like the reference's one-Kafka-topic-per-table, README.md:215),
  usable without any broker. Messages are the sparse-model binary format
  (key/emb_vector pairs) plus a monotonically increasing sequence number.
- ``kafka_message_queue``: the wire-protocol-lite Kafka transport
  (update/kafka_lite.py) — both dialects, all compression codecs, and
  optional consumer-group coordination via ``consumer_group_id``.

Consumer semantics follow the reference knobs: ``poll_timeout_ms``,
``max_batch_size`` (chunked application), ``failure_backoff_ms`` (retry on
apply failure), ``max_commit_interval`` (offset persistence cadence)
(reference backend.cpp:263-308).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from hugectr_backend_tpu_torch.config.params import UpdateSourceParams, UpdateSourceType
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.update")


class MessageProducer:
    """Trainer-side API: publish embedding updates for one model."""

    def post(self, table_tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        raise NotImplementedError


class MessageSource:
    """Inference-side API: pull (table_tag, keys, vectors) batches."""

    def poll(self, timeout_ms: int) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def commit(self) -> None:
        """Persist consumer offsets (reference max_commit_interval)."""

    def close(self) -> None:
        pass


class FileQueueSource(MessageProducer, MessageSource):
    """Durable directory-backed queue; producer and source in one class.

    Layout:
        <root>/<tag>/<seq:012d>.upd   : [n int64 keys][n*dim f32 vectors]
        <root>/<tag>/meta.json        : {"dim": D}
        <root>/.offsets.json          : consumer offsets per tag
    """

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._offsets_path = self.root / ".offsets.json"
        self._offsets: dict[str, int] = {}
        if self._offsets_path.exists():
            self._offsets = json.loads(self._offsets_path.read_text())
        self._lock = threading.Lock()

    # -- producer ------------------------------------------------------------

    def post(self, table_tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        keys = np.ascontiguousarray(keys, dtype="<i8").reshape(-1)
        vectors = np.ascontiguousarray(vectors, dtype="<f4").reshape(keys.shape[0], -1)
        d = self.root / table_tag.replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        meta = d / "meta.json"
        if not meta.exists():
            # Atomic write: the consumer may scan the directory concurrently.
            tmp_meta = d / ".meta.tmp"
            tmp_meta.write_text(json.dumps({"dim": int(vectors.shape[1])}))
            os.replace(tmp_meta, meta)
        payload = (np.int64(keys.shape[0]).tobytes() + keys.tobytes()
                   + vectors.tobytes())
        with self._lock:
            # Multi-PROCESS safe sequencing: the in-process lock only
            # serializes threads, so claim the sequence number with an
            # atomic hard link — two producer processes racing the same
            # seq cannot silently overwrite each other (link fails with
            # EEXIST and the loser retries the next number).
            tmp = d / f".{os.getpid()}-{threading.get_ident()}.tmp"
            tmp.write_bytes(payload)
            existing = sorted(p.name for p in d.glob("*.upd"))
            seq = int(existing[-1].split(".")[0]) + 1 if existing else 0
            while True:
                try:
                    os.link(tmp, d / f"{seq:012d}.upd")
                    break
                except FileExistsError:
                    seq += 1
            tmp.unlink()
        return seq

    # -- source --------------------------------------------------------------

    def poll(self, timeout_ms: int = 0):
        deadline = time.monotonic() + timeout_ms / 1e3
        while True:
            yielded = False
            for d in sorted(self.root.iterdir()):
                if not d.is_dir():
                    continue
                tag = d.name
                meta = d / "meta.json"
                if not meta.exists():
                    continue
                dim = json.loads(meta.read_text())["dim"]
                start = self._offsets.get(tag, 0)
                for p in sorted(d.glob("*.upd")):
                    seq = int(p.name.split(".")[0])
                    if seq < start:
                        continue
                    try:
                        raw = p.read_bytes()
                        n = int(np.frombuffer(raw[:8], "<i8")[0])
                        keys = np.frombuffer(raw[8 : 8 + 8 * n], "<i8").copy()
                        vecs = (
                            np.frombuffer(raw[8 + 8 * n :], "<f4")
                            .reshape(n, dim)
                            .copy()
                        )
                    except Exception:
                        # Quarantine a corrupt/mismatched file instead of
                        # retrying it forever — a single poison message
                        # must not stall every table's updates. The rename
                        # keeps the bytes for inspection.
                        log.exception(
                            "corrupt update file %s; quarantined as .bad",
                            p,
                        )
                        try:
                            os.replace(p, p.with_suffix(".bad"))
                        except OSError:
                            pass
                        self._offsets[tag] = seq + 1
                        continue
                    self._offsets[tag] = seq + 1
                    yielded = True
                    yield tag, keys, vecs
            if yielded or time.monotonic() >= deadline:
                return
            # Idle wait between rescans: a tight loop would re-glob the
            # whole backlog at 100% CPU for the entire timeout window.
            time.sleep(min(0.01, max(deadline - time.monotonic(), 0)))

    def commit(self) -> None:
        with self._lock:
            tmp = self._offsets_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._offsets))
            os.replace(tmp, self._offsets_path)


def make_update_source(params: UpdateSourceParams, root: Optional[str] = None):
    if params.type == UpdateSourceType.NONE:
        return None
    if params.type == UpdateSourceType.FILE_QUEUE:
        return FileQueueSource(root or params.brokers)
    if params.type == UpdateSourceType.KAFKA_MESSAGE_QUEUE:
        from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource

        return KafkaQueueSource(
            params.brokers,
            receive_buffer_size=max(params.receive_buffer_size, 1 << 16),
            compression=params.compression_type,
            group_id=params.consumer_group_id or None,
        )
    raise ValueError(f"unknown update source {params.type}")


class UpdateConsumer:
    """Background consumer: Source -> DRAM/SSD tiers (reference's engine-side
    Kafka consumer loop with backoff + periodic commit)."""

    def __init__(
        self,
        source: MessageSource,
        apply_fn: Callable[[str, np.ndarray, np.ndarray], None],
        params: UpdateSourceParams,
    ):
        self.source = source
        self.apply_fn = apply_fn
        self.params = params
        self._stop = threading.Event()
        self._applied = 0
        self._since_commit = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hps-update-consumer"
        )

    def start(self) -> "UpdateConsumer":
        self._thread.start()
        return self

    def _loop(self):
        # Batches APPLY as they stream out of poll() (lazy iteration):
        # materializing the whole poll first meant a periodic commit could
        # persist offsets for batches later in the list that were not yet
        # applied — a crash then skipped them forever (silent update loss).
        aborted = False
        while not self._stop.is_set():
            got = False
            try:
                for tag, keys, vecs in self.source.poll(
                        self.params.poll_timeout_ms):
                    got = True
                    # Chunk by max_batch_size (reference doc:612-615).
                    mb = max(self.params.max_batch_size, 1)
                    for i in range(0, keys.shape[0], mb):
                        chunk_k = keys[i : i + mb]
                        chunk_v = vecs[i : i + mb]
                        while not self._stop.is_set():
                            try:
                                self.apply_fn(tag, chunk_k, chunk_v)
                                break
                            except Exception:
                                log.exception(
                                    "update apply failed; backing off %d ms",
                                    self.params.failure_backoff_ms,
                                )
                                time.sleep(
                                    self.params.failure_backoff_ms / 1e3)
                        else:
                            # stop() interrupted an unapplied chunk: its
                            # offset is already advanced in memory, so the
                            # final commit must be skipped — the batch
                            # replays on restart (idempotent upserts).
                            aborted = True
                    if aborted:
                        break
                    self._applied += 1
                    self._since_commit += 1
                    if self._since_commit >= self.params.max_commit_interval:
                        self.source.commit()
                        self._since_commit = 0
            except Exception:
                log.exception(
                    "update source poll failed; backing off %d ms",
                    self.params.failure_backoff_ms,
                )
                time.sleep(self.params.failure_backoff_ms / 1e3)
                continue
            if not got:
                time.sleep(self.params.poll_timeout_ms / 1e3)
        if not aborted:
            self.source.commit()

    @property
    def applied_batches(self) -> int:
        return self._applied

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
