"""Capacity tiering: a table bigger than the card's budget served from a UVM
cache over DRAM + SSD tiers, with INT4 rows doubling the resident capacity.

The reference serves terabyte-scale tables the same way (GPU cache over
CPU-memory + RocksDB tiers, docs/hierarchical_parameter_server.md:40-43,
548-573). Here 10 % of a 50,000 x 32 table's rows live on the card as int4
nibbles with an f32 scale a row (``quant_bits: 4``, ~2x int8's rows per byte
of the card's memory); the DRAM tier (``parallel_hash_map``) holds the
whole table, the SSD tier (``rocks_db``) a full copy. Kernels: K1
(``csrc/gather_dequant.cu``, its int4 path: two rows' nibbles unpacked and
scaled) once per lookup.

    python -m hugectr_backend_tpu_torch.examples.06_capacity_tiering_int4 [--device cpu]
"""

import numpy as np

from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
from hugectr_backend_tpu_torch.examples._common import check, cli, workdir
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table

ROWS, DIM = 50_000, 32
INT4_BOUND = 1 / 14  # half an int4 step of a row in [-1, 1] (7 levels a side)


def main(device=None, root=None, state=None) -> dict:
    with workdir(root, "hps_example_") as root:
        table = make_synthetic_table(ROWS, DIM, seed=0)
        write_sparse_model(root / "big", table.keys, table.vectors)
        ps = HierParameterServer.create({
            # SSD tier holds the full copy (reference persistent_db); DRAM
            # holds the volatile working set. UVM pins the whole table in
            # DRAM too, so steady-state misses never reach the SSD.
            "persistent_db": {"type": "rocks_db", "path": str(root / "ssd")},
            "volatile_db": {"type": "parallel_hash_map"},
            "models": [{
                "model": "big",
                "sparse_files": [str(root / "big")],
                "embedding_vecsize_per_table": [DIM],
                "maxnum_catfeature_query_per_table_per_sample": [8],
                "max_batch_size": 256,
                # Only 10% of rows fit the card's budget -> hot cache.
                "gpucacheper": 0.1,
                "embedding_cache_type": "uvm",
                "hit_rate_threshold": 0.9,
                "quant_bits": 4,  # int4: 2x the resident rows per byte
            }],
        }, device=device)
        try:
            cache = ps.get_embedding_cache("big", 0)
            sess = LookupSession.create(ps.get_model_params("big"), cache)
            rng = np.random.default_rng(1)

            # Zipf-hot traffic: most hits come from the 10% resident slice
            # after warm-up; cold keys read through the DRAM (UVM-pinned) tier.
            hot = table.keys[rng.zipf(1.3, 2_000) % ROWS]
            out = sess.lookup_numpy([hot])[0]
            err = float(np.abs(out - expected_vector(hot, DIM)).max())
            print(f"zipf batch of {hot.size}: max int4 error {err:.4f} (bound {INT4_BOUND:.4f})")
            check(err <= INT4_BOUND + 1e-5, f"int4 error {err} past {INT4_BOUND}")

            hit_rate = cache.hit_meter.rate(0)
            print(f"cache hit-rate after warm-up: {hit_rate:.2f}")

            # A key absent everywhere returns the default row (zeros).
            miss = sess.lookup_numpy([np.array([-12345], np.int64)])[0]
            check(np.allclose(miss, 0.0), f"a missing key gave {miss}")
            print("missing key -> default row OK")
        finally:
            ps.shutdown()

    # Capacity math this configuration buys on a card (both flavors carry
    # f32 per-row scales; the ratio approaches 2x as DIM grows past the
    # scale cost).
    int8_bytes = ROWS * DIM + ROWS * 4       # 1 B/element + f32 scales
    int4_bytes = ROWS * DIM // 2 + ROWS * 4  # packed nibbles + f32 scales
    print(f"full-table bytes: int8 {int8_bytes/1e6:.1f} MB vs int4 {int4_bytes/1e6:.1f} MB "
          f"({int8_bytes/int4_bytes:.2f}x more rows per byte at dim {DIM}; -> 2x "
          "asymptotically)")
    return {"keys": hot, "output": out, "max_err": err, "hit_rate": hit_rate,
            "miss": miss, "int8_bytes": int8_bytes, "int4_bytes": int4_bytes}


if __name__ == "__main__":
    cli(main, __doc__)
