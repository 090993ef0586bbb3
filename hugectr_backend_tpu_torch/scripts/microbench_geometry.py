"""K1's cost by table geometry: flat int8 [R, 128] tables by row count, slot
count and lookup group kind.

Port of the JAX package's ``scripts/microbench_geometry.py``, which mapped
the TPU gather's per-op wall by table size class. On the card: K1 on flat
int8 tables of R = 16,384, 131,072, 1,048,576 and 10,137,600 rows (the
script's ``ROWS_BIG``), at 1,024, 4,096 and 26,624 slots (``SLOT_COUNTS``),
Zipf(1.05) keys as the script draws them, with:

- ``arena``: K1 with device scales (``gather_dequant``), the script's leg;
- ``solo``: K1 with per-key scales, the kind a table past 65,536 rows
  takes in a lookup (``gather_dequant_groups``, one gather group);
- ``onehot``: K1's one-hot group (the member's bounds, per-key scales),
  where R admits it (R <= 4,096 with the default row: a table of 4,096
  rows is added for this axis; a deployment puts tables of up to 65,536
  rows in the arena and the rest solo);
- ``index_select``: the rows alone, no dequant (a yardstick);

each beside its bytes bound (``common.gather_bytes``: each distinct row,
the slots, the scales and the f32 output once, over the card's memory
rate). The script's blocked [K, 1M, 128] leg and its row-grouped
[R / G, G, 128] legs (G = 16, 64, 128) tuned layouts that kept the TPU
compiler's gather in its fast region. The port stores every table flat
(``ROADMAP.md``, the North star: Hopper's gather has no such limit and K1
takes 64-bit row offsets), so those legs have no card meaning and print no
line; no such layout is added.

The correctness step: every leg's first slot set bit for bit against the
host truth (``common.flat_truth``; per-key scales are the device formula's
value at the slot, so every kind gives the same rows). Timing:
``common.graph_us`` (``n_sets`` slot sets in one CUDA graph, replayed),
not the script's ``lax.scan`` loop. On the CPU (``--device cpu``) only
the correctness step runs; tests pass small ``rows``.

    python -m hugectr_backend_tpu_torch.scripts.microbench_geometry [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_groups
from hugectr_backend_tpu_torch.scripts.common import (
    DIM,
    ZIPF_A,
    card_info,
    flat_truth,
    gather_bytes,
    gen_flat,
    graph_us,
    host_scale,
    peaks,
    timed_line,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

SLOT_COUNTS = (1024, 4096, 26624)
ROWS_BIG = 10_137_600
ROWS = (4096, 16_384, 131_072, 1_048_576, ROWS_BIG)
ONEHOT_MAX_ROWS = 4096  # a one-hot member's rows, its default row included
N_SETS = 20


def slots_for(seed: int, rows: int, n: int) -> np.ndarray:
    """The script's ``slots_for``: zipf(1.05) % rows, int32."""
    return (np.random.default_rng(seed).zipf(ZIPF_A, n) % rows).astype(np.int32)


def kinds(values, scales, rows: int):
    """-> {kind: fn(slots, per-key scales) -> [n, D] f32} for a table of
    ``rows`` rows."""

    def group(meta):
        def fn(s, c):
            b = ((0, s.shape[0]),)
            return gather_dequant_groups([values], [None], s, c, meta(s.shape[0]), b, b)[0]
        return fn

    out = {"arena": lambda s, c: gather_dequant(values, scales, s),
           "solo": group(lambda n: (("gather",),))}
    if rows <= ONEHOT_MAX_ROWS:
        out["onehot"] = group(lambda n: (("onehot", (0,), (rows,), (n,)),))
    out["index_select"] = lambda s, c: torch.index_select(values, 0, s)
    return out


def run(device=None, rows=ROWS, slot_counts=SLOT_COUNTS, n_sets: int = N_SETS,
        emit=None) -> list:
    """Check every kind at every (R, slots), and time it on a card. -> the
    result lines."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    info = card_info(dev)
    bw = peaks(info["card"])[0] if timed else None
    out = []

    def put(line):
        out.append({"bench": "microbench_geometry", **line, "device": info["device"]})
        (emit or _print)(out[-1])

    with torch.inference_mode():
        for r in rows:
            values, scales = gen_flat(r, dev)
            fns = kinds(values, scales, r)
            for n in slot_counts:
                host = [slots_for(sd, r, n) for sd in range(1, n_sets + 1)]
                sets = [(torch.from_numpy(h).to(dev), torch.from_numpy(host_scale(h)).to(dev))
                        for h in host]
                want = flat_truth(host[0], "device")
                for kind, fn in fns.items():
                    got = fn(*sets[0]).cpu()
                    truth = flat_truth(host[0], None) if kind == "index_select" else want
                    if not np.array_equal(got.float().numpy(), truth):
                        raise AssertionError(f"microbench_geometry R {r} n {n} {kind}: != "
                                             "host truth")
                    head = {"rows": r, "slots": n, "kind": kind}
                    if not timed:
                        put({**head, "check": "bit-exact vs host truth"})
                        continue
                    scales_of = {"arena": "device", "index_select": None}.get(kind, "per-key")
                    nbytes = gather_bytes(host, DIM, DIM, scales_of)
                    if kind == "index_select":
                        nbytes -= n * DIM * 3  # int8 rows out, not f32
                    us = graph_us([lambda s=s, c=c, fn=fn: fn(s, c) for s, c in sets])
                    put({**timed_line(n, us, nbytes, **head), "bound_us": nbytes / bw * 1e6,
                         "x_bound": us / (nbytes / bw * 1e6)})
            del values, scales, fns
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
