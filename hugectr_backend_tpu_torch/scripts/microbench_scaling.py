"""Sharded lookups: all_to_all against psum at P = 2, 4 and 8 shards, every
shard on the one card.

Port of the JAX package's ``scripts/microbench_scaling.py`` (its virtual
CPU mesh). One table of ``ROWS`` x 128, int8, row-sharded through the
port's ``parallel/`` (``make_mesh(table=P, devices=[card] * P)``,
``ShardedTable``, ``sharded_lookup``), 4,096 Zipf(1.05) keys a lookup
through a random popularity -> key permutation (as the JAX script: the zipf
rank decides hotness, the permutation which key). Per P:

- rows gathered per shard: the all_to_all plan's deduplicated bucket
  capacity (median over 5 slot sets) against the N every shard gathers
  under psum;
- the exchange's bytes per shard, from the shapes (not measured):
  all_to_all receives (P - 1) x cap x D x 4, psum's ring all-reduce of
  [N, D] f32 moves 2 (P - 1) / P x N x D x 4;
- wall per lookup (host clock to a synchronize, median of ``REPS``: the
  host plan, the uploads, K1 over every shard in one launch, the combine)
  and device time per lookup (``common.device_profile``).

All shards are on ONE card: the combine is copies within it, so no
exchange between cards is measured. The correctness step: both strategies'
rows equal bit for bit at every P, and equal the unsharded rows of P = 1.

    python -m hugectr_backend_tpu_torch.scripts.microbench_scaling [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from hugectr_backend_tpu_torch.scripts.common import card_info, device_profile
from hugectr_backend_tpu_torch.tiers.hbm import default_device

N, D, ROWS = 4096, 128, 1_000_000
REPS = 30
SHARDS = (2, 4, 8)


def run(device=None, rows: int = ROWS, n: int = N, shards=SHARDS, reps: int = REPS,
        emit=None) -> list:
    """Check and time each P on ``device``. -> the result lines."""
    from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
    from hugectr_backend_tpu_torch.parallel.sharded_table import (
        ShardedTable,
        plan_all_to_all,
        sharded_lookup,
    )

    dev = default_device(device)
    info = card_info(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(np.int64(1) << 40, size=rows, replace=False))
    vecs = rng.standard_normal((rows, D)).astype(np.float32)
    hot = rng.permutation(rows)
    out = []
    whole = ShardedTable.from_numpy(keys, vecs, make_mesh(table=1, devices=[dev]), quant="int8")

    def slots(table, seed):
        r = np.random.default_rng(seed)
        return table.slots_for(keys[hot[r.zipf(1.05, n) % rows]])

    want = sharded_lookup(whole, slots(whole, 999), "psum").cpu()
    del whole
    for p in shards:
        tbl = ShardedTable.from_numpy(keys, vecs, make_mesh(table=p, devices=[dev] * p),
                                      quant="int8")
        caps = [plan_all_to_all(slots(tbl, s), p, tbl.rows_padded // p)[0].shape[1]
                for s in range(5)]
        cap = int(np.median(caps))
        line = {"bench": "microbench_scaling", "shards": p, "batch": n, "dim": D,
                "table_rows": rows, "a2a_bucket_cap_rows": cap,
                "a2a_local_gather_rows_per_shard": cap, "psum_local_gather_rows_per_shard": n,
                "a2a_exchange_bytes_per_shard": (p - 1) * cap * D * 4,
                "psum_exchange_bytes_per_shard": int(2 * (p - 1) / p * n * D * 4),
                "exchange_note": "bytes from the exchanged shapes; every shard on one card, "
                                 "no exchange between cards measured",
                "device": info["device"]}
        sl = slots(tbl, 999)
        got = {s: sharded_lookup(tbl, sl, s).cpu() for s in ("all_to_all", "psum")}
        if not (torch.equal(got["all_to_all"], got["psum"]) and torch.equal(got["psum"], want)):
            raise AssertionError(f"microbench_scaling P={p}: the strategies or the unsharded "
                                 "rows disagree")
        for strategy in ("all_to_all", "psum"):
            sets = [slots(tbl, s) for s in range(reps)]
            walls = []
            for s in sets:
                t0 = time.perf_counter()
                sharded_lookup(tbl, s, strategy)
                sync()
                walls.append((time.perf_counter() - t0) * 1e6)
            tag = "a2a" if strategy == "all_to_all" else "psum"
            line[f"{tag}_wall_us_median"] = float(np.median(walls))
            if dev.type == "cuda":
                busy, _ = device_profile(lambda: [sharded_lookup(tbl, s, strategy)
                                                  for s in sets[:10]], 10)
                line[f"{tag}_device_us"] = None if busy is None else busy * 1e3
        out.append(line)
        (emit or _print)(line)
        del tbl
    return out


def _print(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda[:i] (default) or cpu")
    run(p.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
