"""K1 on int4 against int8 solo tables: does halving the bytes of a row
halve the gather's time on HBM3?

Port of the JAX package's ``scripts/microbench_int4_gather.py``. Its
tables, built on the device: ``ROWS`` x 128, row r holding ``(r * 131) %
255 - 127`` (int8, 128 B a row) or ``(r * 131) % 15 - 7`` nibble-packed
(int4, 64 B a row: even columns in the low nibble), the solo path's
per-key scales (0.013 a key) as an input, Zipf(1.05) slots (``slots_for``:
``default_rng(seed).zipf(1.05, BATCH) % ROWS``). K1
(``gather_dequant``) on both, each over ``N_SETS`` slot sets captured in one
CUDA graph (``common.graph_us``), beside its bound (``common.gather_bytes``:
each distinct row once, the slots, the per-key scales and the f32 output)
and ``index_select`` on the same rows (no dequant). The correctness step:
each output equals its closed form bit for bit.

    python -m hugectr_backend_tpu_torch.scripts.microbench_int4_gather [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
from hugectr_backend_tpu_torch.scripts.common import (
    card_info,
    gather_bytes,
    graph_us,
    peaks,
    timed_line,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

DIM = 128
BATCH = 4096
ROWS = 2_000_000
SCALE = 0.013
N_SETS = 8


def gen_tables(rows: int, device):
    """-> (int8 [rows, 128], nibble-packed int4 [rows, 64] uint8), built on
    ``device``: every column of row r holds its row's value."""
    v = torch.arange(rows, dtype=torch.int32, device=device) * 131
    q8 = (v % 255 - 127).to(torch.int8)[:, None].expand(rows, DIM).contiguous()
    nib = ((v % 15 - 7) & 0xF).to(torch.uint8)
    q4 = (nib | (nib << 4))[:, None].expand(rows, DIM // 2).contiguous()
    return q8, q4


def truth(slots: np.ndarray, bits: int) -> np.ndarray:
    """The closed form of row ``slots`` times the per-key scale: [n, 128] f32."""
    v = np.asarray(slots, np.int64) * 131
    q = (v % 255 - 127) if bits == 8 else (v % 15 - 7)
    return np.repeat((q.astype(np.float32) * np.float32(SCALE))[:, None], DIM, axis=1)


def slots_for(seed: int, batch: int = BATCH, rows: int = ROWS) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (r.zipf(1.05, batch) % rows).astype(np.int32)


def run(device=None, batch: int = BATCH, rows: int = ROWS, emit=None) -> list:
    """Check both tables, and time them on a card. -> the result lines."""
    dev = default_device(device)
    info = card_info(dev)
    q8, q4 = gen_tables(rows, dev)
    sets = [slots_for(s, batch, rows) for s in range(1, N_SETS + 1)]
    dsets = [torch.from_numpy(s).to(dev) for s in sets]
    scin = torch.full((batch,), SCALE, dtype=torch.float32, device=dev)
    out = []
    for bits, table in ((8, q8), (4, q4)):
        got = gather_dequant(table, None, dsets[0], scin)
        if not np.array_equal(got.cpu().numpy(), truth(sets[0], bits)):
            raise AssertionError(f"microbench_int4_gather int{bits}: != the closed form")
        row_bytes = table.shape[1]
        line = {"bench": "microbench_int4_gather", "table": f"int{bits} solo, per-key scales",
                "rows": rows, "row_bytes": row_bytes, "check": "bit-exact vs the closed form",
                "device": info["device"]}
        if dev.type == "cuda":
            us = graph_us([lambda s=s, t=table: gather_dequant(t, None, s, scin) for s in dsets])
            nbytes = gather_bytes(sets, row_bytes, DIM, "per-key")
            idx = [s.long() for s in dsets]
            lib = graph_us([lambda i=i, t=table: torch.index_select(t, 0, i) for i in idx])
            line = timed_line(batch, us, nbytes, **line)
            line.update({"bound_us": nbytes / peaks(info["card"])[0] * 1e6,
                         "index_select_us": lib})
        out.append(line)
        (emit or _print)(line)
    if dev.type == "cuda":
        t8, t4 = (ln["us_per_batch"] for ln in out)
        line = {"bench": "microbench_int4_gather", "int4_over_int8_time": t4 / t8,
                "int4_over_int8_bytes": (gather_bytes(sets, DIM // 2, DIM, "per-key")
                                         / gather_bytes(sets, DIM, DIM, "per-key")),
                "device": info["device"]}
        out.append(line)
        (emit or _print)(line)
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
