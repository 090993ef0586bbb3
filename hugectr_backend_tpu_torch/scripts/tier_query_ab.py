"""Time the DRAM tier's queries in a given source tree, so that two trees can
be held against each other in one call on one card.

    python3 hugectr_backend_tpu_torch/scripts/tier_query_ab.py [--tree DIR] [--out FILE]

It imports the port and ``chip_smoke.py`` from ``DIR`` (default: the tree that
holds this script), builds that tree's native host library, and prints one JSON
line per measurement (milliseconds, medians of 10 after 2 warm-ups):

- ``dram_query``: ``NativeDramKVTier.query`` on one table of 262,144 x 128
  f32 rows (the capped Criteo table), for 1 to 65,536 keys (half of them
  absent), and ``insert`` of as many present keys;
- ``miss_shaped``: the DRAM queries one Zipf(1.05) batch of 4,096 keys a table
  sends when half of each table is on the card and half in DRAM (chip_smoke's
  ``dynamic_tiers`` deployment): per table, the keys outside the card's half,
  one query a table, summed over the 26 tables;
- ``slotmap_acquire``: the dynamic cache's native ``SlotMap`` (the tree's
  ``hps_slotmap_*``, bound here with ``ctypes``) full at 131,072 keys (a
  capped Criteo table at gpucacheper 0.5), acquiring 1 to 16,384 new keys,
  each one an eviction of the least recently used key;
- ``dispatch_breakdown``: chip_smoke's front-end breakdown of one merged batch
  of 166 samples (its ``dram_tier_queries`` entry is the miss merge's DRAM
  queries) on the static deployment of the front-end phase.

Every line carries the tree, the card's name and its power limit. It needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

QUERY_SIZES = (1, 16, 128, 1024, 8192, 65536)
EVICT_SIZES = (1, 128, 2048, 16384)
SLOTMAP_CAPACITY = 131_072
MERGED_BATCH = 166  # the mean merged batch of chip_smoke's front-end phase


def median_ms(fn, n: int = 10, warmup: int = 2) -> float:
    runs = []
    for _ in range(n + warmup):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    runs = sorted(runs[warmup:])
    return runs[len(runs) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the source tree to time (its root)")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("tier_query_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.config.params import VolatileDatabaseParams
    from hugectr_backend_tpu_torch.native import kvstore

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    out = open(args.out, "a") if args.out else None

    def emit(line):
        line = {**line, "tree": tree, "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    kvstore.load_lib()
    rng = np.random.default_rng(cs.SEED)
    n_rows, dim = cs.ROW_CAP, cs.DIM
    keys = rng.choice(1 << 40, n_rows, replace=False).astype(np.int64)
    tier = kvstore.NativeDramKVTier(VolatileDatabaseParams())
    tier.create_table("t", dim)
    tier.insert("t", keys, rng.standard_normal((n_rows, dim)).astype(np.float32))
    for n in QUERY_SIZES:
        q = np.concatenate([keys[rng.integers(0, n_rows, n - n // 2)],
                            -1 - rng.integers(0, 1 << 40, n // 2)])
        up = keys[rng.integers(0, n_rows, n)]
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        emit({"dram_query": n, "query_ms": median_ms(lambda: tier.query("t", q)),
              "insert_ms": median_ms(lambda: tier.insert("t", up, vecs))})
    tier.drop_table("t")

    # The parent tree builds these symbols without binding them.
    lib = kvstore.load_lib()
    vp = ctypes.c_void_p
    lib.hps_slotmap_create.restype = vp
    lib.hps_slotmap_create.argtypes = [ctypes.c_int64]
    lib.hps_slotmap_destroy.argtypes = [vp]
    lib.hps_slotmap_acquire.restype = ctypes.c_int64
    lib.hps_slotmap_acquire.argtypes = [vp, ctypes.c_int64, vp, vp, vp]

    def acquire(handle, k):
        slots = np.empty(k.size, np.int32)
        evicted = np.empty(k.size, np.int64)
        lib.hps_slotmap_acquire(handle, k.size, k.ctypes.data, slots.ctypes.data,
                                evicted.ctypes.data)
        return evicted

    for n in EVICT_SIZES:
        runs = []
        for r in range(5):
            h = lib.hps_slotmap_create(SLOTMAP_CAPACITY)
            acquire(h, np.arange(SLOTMAP_CAPACITY, dtype=np.int64))
            fresh = SLOTMAP_CAPACITY + r * n + np.arange(n, dtype=np.int64)
            t0 = time.perf_counter()
            evicted = acquire(h, fresh)
            runs.append((time.perf_counter() - t0) * 1e3)
            lib.hps_slotmap_destroy(h)
            assert (evicted != np.iinfo(np.int64).min).all()
        emit({"slotmap_acquire": n, "capacity": SLOTMAP_CAPACITY,
              "ms": sorted(runs)[len(runs) // 2]})

    cards = [min(c, cs.ROW_CAP) for c in cs.CRITEO_CARDS]
    with tempfile.TemporaryDirectory(prefix="hps_tier_ab_") as root:
        tables, cfg = cs.build_deployment(root, cards, dim, cs.SEED)
        # The dynamic deployment's miss pattern against its DRAM tier.
        dram = kvstore.NativeDramKVTier(VolatileDatabaseParams())
        misses = []
        for t, tbl in enumerate(tables):
            dram.create_table(str(t), dim)
            dram.insert(str(t), tbl.keys[: tbl.num_rows // 2], tbl.vectors[: tbl.num_rows // 2])
            on_card = np.sort(tbl.keys)[: -(-tbl.num_rows // 2)]
            k = tbl.keys[rng.zipf(cs.FRONTEND_ZIPF, cs.BATCH) % tbl.num_rows]
            misses.append(np.unique(k[~np.isin(k, on_card)]))
        emit({"miss_shaped": sum(m.size for m in misses), "tables_with_misses": sum(
            m.size > 0 for m in misses), "query_ms": median_ms(
            lambda: [dram.query(str(t), m) for t, m in enumerate(misses) if m.size])})
        del dram
        ps = HierParameterServer.create(cfg)
        session = LookupSession.create(ps.get_model_params("dlrm"),
                                       ps.get_embedding_cache("dlrm", 0))
        emit({"dispatch_breakdown": cs.dispatch_breakdown(session, tables, MERGED_BATCH)})
        ps.shutdown()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
