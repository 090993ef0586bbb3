"""Kafka update stream with compression + consumer-group coordination.

The reference consumes trainer updates through librdkafka (reference
docs/hierarchical_parameter_server.md:575-646); this example runs the same
shape fully in-process: an embedded mini broker (3 partitions/topic), a
trainer-side producer with ``compression.type=lz4``, and TWO "inference
node" consumers in one consumer group that split the partitions between
them (JoinGroup/SyncGroup, range assignor) and commit offsets to the
broker — so neither re-reads the other's share.

Host only: no tensor reaches a device, so ``device`` is accepted for a
uniform command line and not used. Without the ``lz4`` wheel the consumers'
lz4 blocks decode in the port's native library (``native/kvstore.cpp``).

    python -m hugectr_backend_tpu_torch.examples.08_kafka_groups_compression
"""

import threading

import numpy as np

from hugectr_backend_tpu_torch.examples._common import check, cli
from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker


def lz4_decoder() -> str:
    """Which lz4 decoder the consumers use: the wheel or the native library."""
    try:
        import lz4.frame  # noqa: F401
    except ImportError:
        return "native"
    return "lz4 wheel"


def main(device=None, root=None, state=None) -> dict:
    broker = MiniKafkaBroker(num_partitions=3).start()
    broker.rebalance_window_s = 0.3
    print(f"mini broker on 127.0.0.1:{broker.port} (3 partitions/topic)")
    try:
        # Trainer side: lz4-compressed update batches, spread across
        # partitions by the stock murmur2 key partitioner.
        trainer = KafkaQueueSource(f"127.0.0.1:{broker.port}", compression="lz4")
        rng = np.random.default_rng(0)
        posted = {}
        for i in range(9):
            tag = f"hps_et.demo.t{i % 3}"
            keys = np.arange(8, dtype=np.int64) + 1000 * i
            vecs = rng.standard_normal((8, 16)).astype(np.float32)
            trainer.post(tag, keys, vecs)
            posted.setdefault(tag, []).append((keys, vecs))
        print("trainer posted 9 lz4-compressed update batches over 3 topics")

        # Inference side: two nodes, one group.
        node_a = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="hps-serving")
        node_b = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="hps-serving")
        got = {"a": [], "b": []}
        ta = threading.Thread(target=lambda: got["a"].extend(node_a.poll(10)))
        tb = threading.Thread(target=lambda: got["b"].extend(node_b.poll(10)))
        ta.start(); tb.start(); ta.join(); tb.join()  # noqa: E702

        assigned = {}
        for name, node in (("a", node_a), ("b", node_b)):
            assigned[name] = {t: pids for t, pids in (node._assignment or {}).items()}
            n = sum(len(k) for _, k, _ in got[name])
            print(f"node {name}: assigned {assigned[name]}, consumed {n} updated rows")
        total = sum(len(k) for rows in got.values() for _, k, _ in rows)
        check(total == 9 * 8, f"{total} rows consumed, 72 posted")
        print(f"exactly-once split: {total} rows total, no double-apply")
        node_a.commit(); node_b.commit()  # noqa: E702
        print("offsets committed to the broker (OffsetCommit v1, generation-fenced)")
        node_a.close(); node_b.close(); trainer.close()  # noqa: E702
    finally:
        broker.stop()
    # Every posted row arrived once, with its bytes.
    rows = {}
    for tag, keys, vecs in (r for rs in got.values() for r in rs):
        for k, v in zip(np.asarray(keys), np.asarray(vecs)):
            check((tag, int(k)) not in rows, f"{tag} key {k} consumed twice")
            rows[(tag, int(k))] = v
    for tag, batches in posted.items():
        for keys, vecs in batches:
            for k, v in zip(keys, vecs):
                check(np.array_equal(rows.get((tag, int(k))), v),
                      f"{tag} key {k}: the consumed row is not the posted one")
    print(f"lz4 decoder: {lz4_decoder()}")
    print("done")
    return {"total": total, "assigned": assigned, "rows": rows, "lz4_decoder": lz4_decoder()}


if __name__ == "__main__":
    cli(main, __doc__)
