"""Shared pieces of the lookup microbenchmarks: the synthetic tables, the
Zipf keys, the tile-padded arena of the tiny tables and the CUDA-graph timer.

The tables and keys are those of the JAX package's ``scripts/microbench_*.py``:
row ``r`` of a table holds ``(r * 131) % 255 - 127`` in every column (int8)
with the scale ``0.01 + (r % 50) * 0.001`` (f32: one multiply, then one
add), and each table's keys are ``np.random.default_rng(seed).zipf(1.05,
batch) % cards``, drawn table after table from one generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.onehot_gather import (
    R_TILE,
    OnehotPlan,
    plan_onehot_worklist,
)

DIM = 128
BATCH = 4096
N_SETS = 20  # distinct slot sets per timed graph
ZIPF_A = 1.05
# The 16 Criteo-Kaggle tables under 6k rows, the one-hot group of both
# microbenchmarks.
TINY_CARDS = [1460, 583, 305, 24, 633, 3, 5683, 3194, 27, 10, 5652, 2173, 4,
              18, 15, 105]


def gen_flat(rows: int, device) -> "tuple[torch.Tensor, torch.Tensor]":
    """-> (values [rows, DIM] int8, scales [rows] f32), built on ``device``
    (a multi-GB table never crosses from the host)."""
    i = torch.arange(rows, dtype=torch.int32, device=device)
    v = ((i * 131) % 255 - 127).to(torch.int8)
    values = v[:, None].expand(rows, DIM).contiguous()
    scales = 0.01 + (i % 50).float() * 0.001
    return values, scales


def flat_truth(slots: np.ndarray, scales: "str | float | None") -> np.ndarray:
    """Host truth of :func:`gen_flat`'s rows at ``slots``, in closed form:
    the rows times their scale (``"device"``), times a per-key constant (a
    float) or unscaled (None). -> [n, DIM] f32."""
    r = np.asarray(slots, np.int64)
    v = ((r * 131) % 255 - 127).astype(np.float32)
    if scales == "device":
        v = v * (np.float32(0.01) + (r % 50).astype(np.float32) * np.float32(0.001))
    elif scales is not None:
        v = v * np.float32(scales)
    return np.repeat(v[:, None], DIM, axis=1)


def zipf_slots(seed: int, bases, cards, batch: int) -> np.ndarray:
    """Per table, ``base + zipf(1.05) % cards``, tables concatenated. -> [batch
    * len(cards)] int32."""
    r = np.random.default_rng(seed)
    return np.concatenate([b + (r.zipf(ZIPF_A, batch) % c)
                           for b, c in zip(bases, cards)]).astype(np.int32)


def tile_layout(cards, r_tile: int):
    """Each member padded to whole ``r_tile`` tiles, its default row
    included. -> ([(first_tile, num_tiles)], arena rows)."""
    tiles, t0 = [], 0
    for c in cards:
        nt = -(-(c + 1) // r_tile)
        tiles.append((t0, nt))
        t0 += nt
    return tiles, t0 * r_tile


@dataclasses.dataclass
class Arena:
    """A tile-padded arena of :func:`gen_flat` rows and its members' keys."""

    cards: list
    tiles: list        # per member (first row tile, row tiles)
    r_tile: int
    values: torch.Tensor
    scales: torch.Tensor

    @property
    def bases(self):
        return [t0 * self.r_tile for t0, _ in self.tiles]

    def slots(self, seed: int, batch: int) -> "tuple[np.ndarray, torch.Tensor]":
        s = zipf_slots(seed, self.bases, self.cards, batch)
        return s, torch.from_numpy(s).to(self.values.device)

    def plan(self, batch: int, m_tile: int) -> OnehotPlan:
        return plan_onehot_worklist(self.tiles, [batch] * len(self.cards),
                                    m_tile=m_tile, r_tile=self.r_tile)


def build_arena(cards, r_tile: int, device) -> Arena:
    tiles, rows = tile_layout(cards, r_tile)
    values, scales = gen_flat(rows, device)
    return Arena(list(cards), tiles, r_tile, values, scales)


def gather_bytes(slot_sets, row_bytes: int, dim: int, scales: "str | None") -> float:
    """Bytes a gather of one slot set must move, averaged over the sets:
    each distinct row read once, the slots, the distinct scales
    (``"device"``) or one scale per key (``"per-key"``), and the f32 output
    written once."""
    total = 0.0
    for s in slot_sets:
        n, uniq = s.size, np.unique(s).size
        total += (uniq * row_bytes + n * 4 + n * dim * 4
                  + (uniq * 4 if scales == "device" else n * 4 if scales == "per-key" else 0))
    return total / len(slot_sets)


def graph_us(calls, replays: int = 10) -> float:
    """Device time per call in µs: ``calls`` (one per slot set) captured in
    one CUDA graph, replayed ``replays`` times and timed with CUDA events.
    With a distinct slot set per call, L2 does not turn repeated slots into
    hits that real traffic would not give. Needs a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA card")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * len(calls))
    del graph
    return ms * 1e3


def timed_line(keys: int, us: float, nbytes: float, **fields) -> dict:
    """One result: µs per batch, ns per looked-up row, bytes moved and the
    rate they were moved at."""
    return {**fields, "keys": keys, "us_per_batch": us, "ns_per_row": us * 1e3 / keys,
            "bytes": nbytes, "gb_per_s": nbytes / us / 1e3}
