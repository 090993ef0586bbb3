"""Online updates: trainer -> queue -> tiers -> device cache refresh — the
reference's Kafka pipeline (README.md:213-218) on the file-queue transport.

A 1,000 x 8 f32 table on a static cache; the trainer side posts a new row
for one key through ``FileQueueSource`` under ``tiers.base.table_tag``; the
parameter server's consumer applies it to the tiers, and ``refresh`` copies
it into the cache on the card. Kernels: K1 (``csrc/gather_dequant.cu``, f32
rows, no scales) once per lookup.

    python -m hugectr_backend_tpu_torch.examples.03_online_updates [--device cpu]
"""

import time

import numpy as np

from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
from hugectr_backend_tpu_torch.examples._common import check, cli, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.tiers.base import table_tag
from hugectr_backend_tpu_torch.update import FileQueueSource

DEADLINE_S = 30.0  # the wait for the consumer to apply the update


def main(device=None, root=None, state=None) -> dict:
    with workdir(root, "hps_example_") as root:
        table = make_synthetic_table(1_000, 8, seed=0)
        write_sparse_model(root / "t0", table.keys, table.vectors)
        ps = HierParameterServer.create({
            "update_source": {
                "type": "file_queue",
                "brokers": str(root / "updates"),
                "poll_timeout_ms": 50,
            },
            "models": [{
                "model": "m",
                "sparse_files": [str(root / "t0")],
                "embedding_vecsize_per_table": [8],
                "maxnum_catfeature_query_per_table_per_sample": [4],
                "gpucacheper": 1.0,
                "embedding_cache_type": "static",
                "quant_bits": 32,
            }],
        }, device=device)
        try:
            sess = LookupSession.create(ps.get_model_params("m"),
                                        ps.get_embedding_cache("m", 0))
            key = table.keys[:1]
            before = sess.lookup_numpy([key])[0][0]
            lookups = 1
            print("before update:", before[:4])

            # Trainer side: publish new weights (Message Producer API).
            producer = FileQueueSource(str(root / "updates"))
            new_row = np.full((1, 8), 7.0, np.float32)
            producer.post(table_tag("m", "sparse_embedding0"), key, new_row)

            # Wait for the async consumer and refresh the cache (the
            # periodic refresh_interval cycle does this in production).
            t0 = time.perf_counter()
            while True:
                time.sleep(0.05)
                ps.get_embedding_cache("m", 0).refresh(fraction=1.0)
                after = sess.lookup_numpy([key])[0][0]
                lookups += 1
                if np.array_equal(after, new_row[0]):
                    break
                check(time.perf_counter() - t0 < DEADLINE_S,
                      f"the update was not visible after {DEADLINE_S} s")
            visible_s = time.perf_counter() - t0
            print("after update: ", after[:4])
        finally:
            ps.shutdown()
    return {"key": key, "before": before, "after": after, "visible_s": visible_s,
            "lookups": lookups}


if __name__ == "__main__":
    cli(main, __doc__)
