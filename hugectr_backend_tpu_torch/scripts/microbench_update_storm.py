"""Updates/s through the online update path while lookups keep serving on
the card, and the lookups' p50 / p99 before and during the storm.

Port of the JAX package's ``scripts/microbench_update_storm.py`` (the
reference's trainer -> Kafka -> VDB / PDB -> GPU-cache cycle). One table of
``ROWS`` x 32 behind a dynamic cache at gpucacheper 0.25 on the card, a
hash-map DRAM tier, the SSD tier and a ``kafka_message_queue`` update source
on an in-process ``MiniKafkaBroker`` (3 partitions): a producer thread posts
512-key batches of new rows through ``KafkaQueueSource`` (at most 40 batches
ahead of what the consumer applied), a refresher calls
``refresh_embedding_cache`` every 0.2 s, and this thread looks up 1,024
Zipf(1.05) keys at a time (``LookupSession.lookup_numpy``: K1 on the card
and the copy back) for ``seconds``. Host-dominated: the card only serves
the lookups. The correctness step: after the drain every posted batch has
been applied, and the DRAM tier holds the last posted batch's rows bit for
bit.

    python -m hugectr_backend_tpu_torch.scripts.microbench_update_storm [--device cpu] [--seconds S]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import tempfile
import threading
import time

import numpy as np

from hugectr_backend_tpu_torch.tiers.hbm import default_device

ROWS, DIM = 200_000, 32
UPDATE_BATCH = 512
LOOKUP_BATCH = 1024
MAX_LEAD = 40  # posted batches the producer may run ahead of the consumer


def pcts(lat):
    ls = np.sort(np.asarray(lat))
    n = ls.size
    return float(ls[n // 2]) * 1e3, float(ls[min(int(n * 0.99), n - 1)]) * 1e3


def run(device=None, seconds: float = 10.0, rows: int = ROWS, warm: int = 100,
        base: int = 200, emit=None) -> dict:
    """The storm on ``device`` (the card unless "cpu"). -> the result line."""
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
    from hugectr_backend_tpu_torch.scripts.common import card_info
    from hugectr_backend_tpu_torch.tiers.base import table_tag
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    dev = default_device(device)
    tmp = tempfile.TemporaryDirectory(prefix="hps_storm_")
    tbl = make_synthetic_table(rows, DIM, seed=7, deterministic_fn=False)
    write_sparse_model(f"{tmp.name}/t0", tbl.keys, tbl.vectors)
    broker = MiniKafkaBroker(num_partitions=3).start()
    ps = producer = None
    try:
        ps = HierParameterServer.create({
            "volatile_db": {"type": "parallel_hash_map"},
            "persistent_db": {"type": "rocks_db", "path": f"{tmp.name}/ssd"},
            "update_source": {"type": "kafka_message_queue",
                              "brokers": f"127.0.0.1:{broker.port}", "poll_timeout_ms": 5,
                              "max_batch_size": 8192, "max_commit_interval": 50},
            "models": [{"model": "m", "sparse_files": [f"{tmp.name}/t0"],
                        "embedding_vecsize_per_table": [DIM],
                        "maxnum_catfeature_query_per_table_per_sample": [1],
                        "gpucacheper": 0.25, "embedding_cache_type": "dynamic",
                        "hit_rate_threshold": 0.9}],
        }, device=dev)
        tag = table_tag("m", "sparse_embedding0")
        sess = LookupSession.create(ps.get_model_params("m"), ps.get_embedding_cache("m", 0))
        rng = np.random.default_rng(0)

        def lookup_once():
            q = tbl.keys[rng.zipf(1.05, LOOKUP_BATCH) % rows]
            t0 = time.perf_counter()
            out = sess.lookup_numpy([q])[0]
            dt = time.perf_counter() - t0
            if out.shape != (LOOKUP_BATCH, DIM) or not np.isfinite(out).all():
                raise AssertionError("update storm: a lookup was not finite of its shape")
            return dt

        # The hit meter and the hot resident set first, so that the baseline
        # measures steady serving, not the cold fill.
        for _ in range(warm):
            lookup_once()
        p50_before, p99_before = pcts([lookup_once() for _ in range(base)])
        stop = threading.Event()
        posted = {"batches": 0, "last": None}
        producer = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        applied0 = ps.update_consumer.applied_batches

        def storm():
            r = np.random.default_rng(1)
            while not stop.is_set():
                if posted["batches"] - (ps.update_consumer.applied_batches - applied0) > MAX_LEAD:
                    time.sleep(0.002)
                    continue
                keys = tbl.keys[r.integers(0, rows, UPDATE_BATCH)]
                vecs = r.standard_normal((UPDATE_BATCH, DIM)).astype(np.float32)
                producer.post(tag, keys, vecs)
                posted["last"] = (keys, vecs)
                posted["batches"] += 1

        def refresher():
            while not stop.is_set():
                ps.refresh_embedding_cache("m", 0)
                time.sleep(0.2)

        threads = [threading.Thread(target=storm, daemon=True),
                   threading.Thread(target=refresher, daemon=True)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        storm_lat = []
        try:
            while time.perf_counter() - t0 < seconds:
                storm_lat.append(lookup_once())
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        if any(t.is_alive() for t in threads):
            raise AssertionError("update storm: a producer or refresher thread did not stop")
        wall = time.perf_counter() - t0
        deadline = time.time() + 30
        applied = ps.update_consumer.applied_batches - applied0
        while applied < posted["batches"] and time.time() < deadline:
            time.sleep(0.05)
            applied = ps.update_consumer.applied_batches - applied0
        drain_wall = time.perf_counter() - t0
        if applied != posted["batches"]:
            raise AssertionError(f"update storm: {applied} of {posted['batches']} batches "
                                 "applied after the drain")
        keys, vecs = posted["last"]
        _, last = np.unique(keys[::-1], return_index=True)
        last = keys.shape[0] - 1 - last  # each key's last position in the batch
        got, found = ps.dram.query(tag, keys[last])
        if not found.all() or not np.array_equal(got, vecs[last]):
            raise AssertionError("update storm: the DRAM tier does not hold the last batch")
        p50_during, p99_during = pcts(storm_lat)
        line = {
            "bench": "microbench_update_storm",
            "updates_per_s_posted": posted["batches"] * UPDATE_BATCH / wall,
            "updates_per_s_applied": applied * UPDATE_BATCH / drain_wall,
            "update_batch": UPDATE_BATCH,
            "batches_posted": posted["batches"],
            "batches_applied": applied,
            "lookup_batch": LOOKUP_BATCH,
            "lookup_p50_ms_before": p50_before,
            "lookup_p99_ms_before": p99_before,
            "lookup_p50_ms_during": p50_during,
            "lookup_p99_ms_during": p99_during,
            "lookups_during": len(storm_lat),
            "seconds": wall,
            "host_cpus": multiprocessing.cpu_count(),
            "check": "every batch applied; the last batch's rows in the DRAM tier bit for bit",
            "device": card_info(dev)["device"],
        }
        (emit or _print)(line)
        return line
    finally:
        if producer is not None:
            producer.close()
        if ps is not None:
            ps.shutdown()
        broker.stop()
        tmp.cleanup()


def _print(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda[:i] (default) or cpu")
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    run(a.device, a.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
