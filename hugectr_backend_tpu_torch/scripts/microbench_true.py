"""The Criteo-26 lookup mix at the uncapped Criteo-Kaggle cardinalities.

Port of the JAX package's ``scripts/microbench_true.py``, configs A-J, at
D = 128 int8 and Zipf(1.05) keys, batch 4096 keys per table:

  A  small arena (18 tables, 47,398 rows and a default row each), device scales
  B  small arena, per-key scales (an input, gathered on the host)
  C  small arena, no scales
  D  1 big table (10,131,227 rows), device scales
  E  1 big table, per-key scales
  F  8 big tables (93,145 to 10,131,227 rows, 33,715,179 in all), device scales
  G  8 big tables, per-key scales
  H  the full Criteo-26 mix (A + F), device scales
  I  the full Criteo-26 mix (B + G), per-key scales
  J  K6 v1 (``onehot_gather``, m_tile 4096, r_tile 512) on the 16 tiny tables,
     and J' K1 on the same slots

Each config of A-I is one K1 launch over all its tables
(``gather_dequant_groups``), as the JAX script jits one program per config;
J' is K1 on one table (``gather_dequant``). The JAX script's
config K, the Pallas grouped-DMA gather on one big table with per-key scales,
is K1 itself in the port, so it merges into E. The tables, 33.76M rows x 128
int8 (4.32 GB) and 135 MB of scales, are built on the device.

Each config's calls on ``N_SETS`` distinct slot sets are captured in one
CUDA graph and timed (``common.graph_us``); the first set's output is
checked against the host truth (``common.flat_truth``, the closed form of
the tables) bit for bit. On the CPU (``--device cpu``) only the checks run.

    python -m hugectr_backend_tpu_torch.scripts.microbench_true [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_groups
from hugectr_backend_tpu_torch.ops.onehot_gather import onehot_gather
from hugectr_backend_tpu_torch.scripts.common import (
    BATCH,
    BIG_CARDS,
    DIM,
    N_SETS,
    R_TILE,
    SMALL_CARDS,
    TINY_CARDS,
    build_arena,
    flat_truth,
    gather_bytes,
    gen_flat,
    graph_us,
    timed_line,
    zipf_slots,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

PER_KEY_SCALE = 0.013
ONEHOT_M_TILE = 4096  # config J's m_tile (its r_tile is R_TILE, 512)


def _packed(legs, n_sets: int):
    """The one K1 call of a config: per slot set, every table's slots packed
    into one device tensor, as a lookup uploads them. -> (tables, device
    scales per table, [slots_cat per set], scin_cat, meta, slot bounds,
    scin bounds)."""
    vals, dsc, sb, cb, scin, off, soff = [], [], [], [], [], 0, 0
    for tables, hsets, _, scales in legs:
        for i, (v, s) in enumerate(tables):
            n = hsets[0][i].size
            vals.append(v)
            dsc.append(s if scales == "device" else None)
            sb.append((off, off + n))
            off += n
            if scales == "per-key":
                scin.append(torch.full((n,), PER_KEY_SCALE, device=v.device))
                cb.append((soff, soff + n))
                soff += n
            else:
                cb.append(None)
    cats = [torch.cat([d[k][i] for _, _, d, _ in legs for i in range(len(d[k]))])
            for k in range(n_sets)]
    scin_cat = torch.cat(scin) if scin else None
    return vals, dsc, cats, scin_cat, (("gather",),) * len(vals), tuple(sb), tuple(cb)


def _config_call(packed, k: int) -> list:
    """K1 over every table of a config on slot set ``k``: one launch."""
    vals, dsc, cats, scin_cat, meta, sb, cb = packed
    return gather_dequant_groups(vals, dsc, cats[k], scin_cat, meta, sb, cb)


def run(device=None, batch: int = BATCH, n_sets: int = N_SETS, big_cards=BIG_CARDS,
        small_cards=SMALL_CARDS, tiny_cards=TINY_CARDS, onehot_m_tile: int = ONEHOT_M_TILE,
        emit=None) -> list:
    """Check configs A-J, and time them on a card. -> the result lines (each
    also passed to ``emit``; printed as JSON by default)."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    seeds = range(1, n_sets + 1)
    out = []

    # The small arena: members back to back, each with its default row.
    off = np.concatenate([[0], np.cumsum(np.asarray(small_cards) + 1)])
    arena = gen_flat(int(off[-1]), dev)
    arena_np = [[zipf_slots(sd, off[:-1], small_cards, batch)] for sd in seeds]
    bigs = [gen_flat(c, dev) for c in big_cards]
    big_np = [np.split(zipf_slots(sd, [0] * len(big_cards), big_cards, batch),
                       len(big_cards)) for sd in seeds]
    arena_sets, big_sets = ([[torch.from_numpy(s).to(dev) for s in per] for per in sets]
                            for sets in (arena_np, big_np))

    # config -> legs: (tables, slot sets [set][table] on the host, the same
    # on the device, scales)
    parts = {
        "A": [([arena], arena_np, arena_sets, "device")],
        "B": [([arena], arena_np, arena_sets, "per-key")],
        "C": [([arena], arena_np, arena_sets, None)],
        "D": [(bigs[:1], [p[:1] for p in big_np], [p[:1] for p in big_sets], "device")],
        "E": [(bigs[:1], [p[:1] for p in big_np], [p[:1] for p in big_sets], "per-key")],
        "F": [(bigs, big_np, big_sets, "device")],
        "G": [(bigs, big_np, big_sets, "per-key")],
    }
    parts["H"] = parts["A"] + parts["F"]
    parts["I"] = parts["B"] + parts["G"]
    labels = {"A": "small arena, device scales", "B": "small arena, per-key scales",
              "C": "small arena, no scales", "D": "1 big table, device scales",
              "E": "1 big table, per-key scales (the JAX script's K merges here)",
              "F": "8 big tables, device scales", "G": "8 big tables, per-key scales",
              "H": "Criteo-26, device scales", "I": "Criteo-26, per-key scales"}

    def put(line):
        out.append({"bench": "microbench_true", **line})
        (emit or _print)(out[-1])

    for name, label in labels.items():
        keys, nbytes, rows = 0, 0.0, 0
        packed = _packed(parts[name], n_sets)
        got = iter(_config_call(packed, 0))
        for tables, hsets, _, scales in parts[name]:
            for i, (v, _) in enumerate(tables):
                want = flat_truth(hsets[0][i], "device" if scales == "device"
                                  else PER_KEY_SCALE if scales == "per-key" else None)
                if not np.array_equal(next(got).cpu().numpy(), want):
                    raise AssertionError(f"microbench_true {name}: table {i} != host truth")
                keys += hsets[0][i].size
                rows += v.shape[0]
                nbytes += gather_bytes([h[i] for h in hsets], DIM, DIM, scales)
        head = {"config": name, "label": label, "table_rows": rows}
        put({**head, "check": "bit-exact vs host truth"})
        if timed:
            us = graph_us([lambda k=k: _config_call(packed, k) for k in range(n_sets)])
            put(timed_line(keys, us, nbytes, **head))

    # J: K6 v1 and K1 (J') on the tiny tables' tile-padded arena.
    tiny = build_arena(tiny_cards, R_TILE, dev)
    plan = tiny.plan(batch, onehot_m_tile)
    sets = [tiny.slots(sd, batch) for sd in seeds]
    keys = batch * len(tiny_cards)
    nbytes = gather_bytes([s for s, _ in sets], DIM, DIM, "device")
    for name, label, fn in (
            ("J", f"K6 v1 on {len(tiny_cards)} tiny tables (m_tile {onehot_m_tile}, "
                  f"r_tile {R_TILE})",
             lambda s: onehot_gather(tiny.values, tiny.scales, s, plan)),
            ("J'", "K1 on the same slots", lambda s: gather_dequant(tiny.values,
                                                                     tiny.scales, s))):
        if not np.array_equal(fn(sets[0][1]).cpu().numpy(), flat_truth(sets[0][0], "device")):
            raise AssertionError(f"microbench_true {name}: != host truth")
        head = {"config": name, "label": label, "table_rows": tiny.values.shape[0]}
        put({**head, "check": "bit-exact vs host truth"})
        if timed:
            put(timed_line(keys, graph_us([lambda s=s: fn(s) for _, s in sets]), nbytes,
                           **head))
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
