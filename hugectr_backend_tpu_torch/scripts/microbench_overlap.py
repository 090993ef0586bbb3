"""K1's launch grouping: one launch over many groups against one launch per
group, and sorted slots.

Port of the JAX package's ``scripts/microbench_overlap.py``, which asked how
far XLA overlaps independent gathers in one TPU program. The card's
question is K1's grouping: the port gathers every group of a lookup in one
launch (since slice 6); is that better than a launch per group? Legs, on
``common.gen_flat`` tables with device scales and Zipf(1.05) keys drawn as
the script draws them:

1. One big table (``BIG_CARDS[0]``, 10,131,227 rows) with 4,096 slots split
   into K = 1, 2, 4, 8 and 16 groups: one K1 launch over the K groups
   (``gather_dequant_groups``) against K launches (``gather_dequant``, one
   a group).
2. Sorted slots: ``torch.sort`` before K1, without and with the
   ``index_select`` that puts the rows back in request order.
3. The 18-small-table arena (``SMALL_CARDS``, members back to back, each
   with its default row): its 73,728 slots in K = 1, 2, 4, 8 chunks, one
   launch against K.
4. The production Criteo-26 layout, the 8 ``BIG_CARDS`` and the arena: one
   launch per lookup (what the port does) against one launch per group (9).

The script's leg 2, chunks concatenated before the sum, asked whether XLA
merged chunked gathers back into one; a CUDA program has no such
rewriting, so it has no card meaning and prints no line. The correctness
step: every leg's output bit for bit against the host truth
(``common.flat_truth``), the unpermuted sorted leg after it is put back in
order. Each line carries the bytes bound (``common.gather_bytes`` over the
card's memory rate). Device time by ``common.graph_us`` (``n_sets`` slot
sets in one CUDA graph, replayed; the K launches are in the graph, so
their host cost is not), not the script's ``lax.scan`` loop; legs 1 and 4
also carry ``eager_us``, launched from Python (host clock, median). The big
tables can come from the caller (``big``: rows -> values), so that one
build serves several runs. On the CPU (``--device cpu``) only the
correctness step runs; tests pass capped cards.

    python -m hugectr_backend_tpu_torch.scripts.microbench_overlap [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_groups
from hugectr_backend_tpu_torch.scripts.common import (
    BATCH,
    BIG_CARDS,
    DIM,
    N_SETS,
    SMALL_CARDS,
    ZIPF_A,
    card_info,
    eager_us,
    flat_truth,
    gather_bytes,
    gen_flat,
    gen_scales,
    graph_us,
    peaks,
    timed_line,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

CHUNKS_BIG = (1, 2, 4, 8, 16)
CHUNKS_ARENA = (1, 2, 4, 8)


def make_slots(seed: int, cards, batch: int):
    """The script's ``make_slots``: per table ``zipf(1.05) % card``, one
    generator. -> [int32 array per table]."""
    r = np.random.default_rng(seed)
    return [(r.zipf(ZIPF_A, batch) % c).astype(np.int32) for c in cards]


def arena_slots(seed: int, cards, off, batch: int) -> np.ndarray:
    """The script's ``make_arena_slots``: member after member, ``off[i] +
    zipf(1.05) % card``."""
    r = np.random.default_rng(seed)
    return np.concatenate([off[i] + (r.zipf(ZIPF_A, batch) % c)
                           for i, c in enumerate(cards)]).astype(np.int32)


def _bounds(chunks) -> tuple:
    ends = np.cumsum(chunks).tolist()
    return tuple(zip([0] + ends[:-1], ends))


def one_launch(tables, chunks):
    """K1 over every chunk in one launch. ``tables``: per chunk (values,
    device scales); -> fn(slots_cat) -> [per chunk rows]."""
    vals, dsc = [v for v, _ in tables], [s for _, s in tables]
    meta, none = (("gather",),) * len(chunks), (None,) * len(chunks)
    return lambda s: gather_dequant_groups(vals, dsc, s, None, meta, _bounds(chunks), none)


def per_chunk(tables, chunks):
    """One K1 launch a chunk: -> fn(slots_cat) -> [per chunk rows]."""
    return lambda s: [gather_dequant(v, sc, s[lo:hi]) for (v, sc), (lo, hi) in
                      zip(tables, _bounds(chunks))]


def sort_leg(values, scales, unpermute: bool):
    def fn(s):
        sorted_s, order = torch.sort(s)
        rows = gather_dequant(values, scales, sorted_s)
        if not unpermute:
            return [rows]
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(
            order.numel(), device=order.device))
        return [rows.index_select(0, inv)]
    return fn


def run(device=None, batch: int = BATCH, n_sets: int = N_SETS, big_cards=BIG_CARDS,
        small_cards=SMALL_CARDS, big=None, emit=None) -> list:
    """Check every leg, and time it on a card. ``big``: the big tables'
    values by rows, where the caller has them. -> the result lines."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    info = card_info(dev)
    bw = peaks(info["card"])[0] if timed else None
    big = big or {}
    bigs = [(big[c] if c in big else gen_flat(c, dev)[0], gen_scales(c, dev))
            for c in big_cards]
    off = np.concatenate([[0], np.cumsum(np.asarray(small_cards) + 1)])
    arena = gen_flat(int(off[-1]), dev)
    out = []

    def put(line):
        out.append({"bench": "microbench_overlap", "batch": batch, **line,
                    "device": info["device"]})
        (emit or _print)(out[-1])

    def leg(head, fn, host_sets, in_sorted_order=False, eager=False):
        """Check ``fn`` on the first set against the host truth (rows that
        come in sorted order put back in request order first), then time
        it over every set. ``host_sets``: per set the slots as fed."""
        feeds = [torch.from_numpy(h).to(dev) for h in host_sets]
        got = torch.cat([g.cpu() for g in fn(feeds[0])]).numpy()
        if in_sorted_order:
            back = np.empty_like(got)
            back[np.argsort(host_sets[0], kind="stable")] = got
            got = back
        if not np.array_equal(got, flat_truth(host_sets[0], "device")):
            raise AssertionError(f"microbench_overlap {head}: != host truth")
        if not timed:
            put({**head, "check": "bit-exact vs host truth"})
            return
        nbytes = gather_bytes(host_sets, DIM, DIM, "device")
        us = graph_us([lambda s=s: fn(s) for s in feeds])
        line = {**timed_line(host_sets[0].size, us, nbytes, **head),
                "bound_us": nbytes / bw * 1e6}
        if eager:
            line["eager_us"] = eager_us(lambda: fn(feeds[0]))
        put(line)

    seeds = range(1, n_sets + 1)
    with torch.inference_mode():
        # 1. One big table, K groups.
        one = [make_slots(sd, big_cards[:1], batch)[0] for sd in seeds]
        for k in CHUNKS_BIG:
            chunks = [batch // k] * k
            for name, mk in (("one launch", one_launch), ("K launches", per_chunk)):
                leg({"leg": "1 big table", "rows": big_cards[0], "groups": k, "launches": name},
                    mk([bigs[0]] * k, chunks), one, eager=True)
        # 2. Sorted slots.
        for unpermute in (False, True):
            leg({"leg": "1 big table, sorted", "rows": big_cards[0],
                 "index_select_back": unpermute},
                sort_leg(*bigs[0], unpermute), one, in_sorted_order=not unpermute)
        # 3. The small arena in K chunks.
        ar = [arena_slots(sd, small_cards, off, batch) for sd in seeds]
        n_ar = batch * len(small_cards)
        for k in CHUNKS_ARENA:
            chunks = [n_ar // k] * k
            for name, mk in (("one launch", one_launch), ("K launches", per_chunk)):
                leg({"leg": "small arena", "rows": int(off[-1]), "groups": k, "launches": name},
                    mk([arena] * k, chunks), ar)
        # 4. Criteo-26: the arena and the 8 big tables.
        both = [np.concatenate([a, *make_slots(sd, big_cards, batch)])
                for a, sd in zip(ar, seeds)]
        chunks = [n_ar] + [batch] * len(big_cards)
        for name, mk in (("one launch per lookup", one_launch),
                         ("one launch per group", per_chunk)):
            leg({"leg": "criteo-26", "groups": len(chunks), "launches": name},
                mk([arena] + bigs, chunks), both, eager=True)
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
