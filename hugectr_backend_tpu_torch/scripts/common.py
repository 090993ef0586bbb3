"""Shared pieces of the benchmark programs: the synthetic tables, the Zipf
keys, the tile-padded arena of the tiny tables, the CUDA-graph timers (a
batch of calls, and the slope over chained iterations), the eager timer,
the card's name and power limit, and its published peak rates.

The tables and keys are those of the JAX package's ``scripts/microbench_*.py``:
row ``r`` of a table holds ``(r * 131) % 255 - 127`` in every column (int8)
with the scale ``0.01 + (r % 50) * 0.001`` (f32: one multiply, then one
add), and each table's keys are ``np.random.default_rng(seed).zipf(1.05,
batch) % cards``, drawn table after table from one generator.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

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


#: Published dense peaks (NVIDIA data sheets, without sparsity, at the full
#: power limit): memory bytes/s, bf16 tensor FLOP/s, int8 tensor OP/s, f32
#: FLOP/s outside the tensor cores. Matched by substring, the first hit.
PEAKS = (
    ("H200", 4.8e12, 989e12, 1979e12, 67e12),
    ("H100 NVL", 3.9e12, 835e12, 1671e12, 60e12),
    ("H100 PCIe", 2.0e12, 756e12, 1513e12, 51e12),
    ("H100", 3.35e12, 989e12, 1979e12, 67e12),  # SXM
)


def peaks(name: str):
    """-> (memory bytes/s, bf16 FLOP/s, int8 OP/s, f32 non-tensor FLOP/s) of
    the card named ``name``."""
    for key, *rates in PEAKS:
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates known for {name!r}")


def card_info(device) -> dict:
    """What a result line names its device by: the card's name and what
    ``nvidia-smi --query-gpu=name,power.limit`` says of it, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    idx = dev.index or 0
    smi = subprocess.run(["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(idx)
    return {"device": f"{name} | {smi}", "card": name}


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA card")


def slope_us(step, it_lo: int = 64, it_hi: int = 320, per_graph: int = 0) -> float:
    """Device µs of one ``step()`` whose iterations are chained through the
    device (each reads what the previous wrote): ``per_graph`` steps
    (default ``it_lo // 4``) captured in one CUDA graph, replayed for
    ``it_lo`` and for ``it_hi`` steps, each timed with CUDA events; the
    slope, which leaves out what a replay costs once. Needs a CUDA card."""
    _need_card()
    per_graph = per_graph or max(1, it_lo // 4)
    if it_lo % per_graph or it_hi % per_graph or it_hi <= it_lo:
        raise ValueError(f"slope_us: {it_lo} and {it_hi} steps in graphs of {per_graph}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(n):
        start.record()
        for _ in range(n // per_graph):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    timed(it_lo)
    lo, hi = timed(it_lo), timed(it_hi)
    del graph
    return (hi - lo) / (it_hi - it_lo) * 1e3


def eager_us(step, iters: int = 20) -> float:
    """µs of one ``step()`` launched from Python without a graph: host clock
    from the call to ``torch.cuda.synchronize()`` (on a card), median over
    ``iters``. On the CPU it is the CPU's time."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def device_profile(run, n: int):
    """Device kernel time per unit of work (``torch.profiler``), over
    ``run()``, which does ``n`` units, and the kernels that take it. -> (ms
    or None where the profiler saw no device events, [(kernel name, ms per
    unit)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None, []
    top = sorted(((k[:80], v / n) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return sum(by_name.values()) / n, top


def timed_line(keys: int, us: float, nbytes: float, **fields) -> dict:
    """One result: µs per batch, ns per looked-up row, bytes moved and the
    rate they were moved at."""
    return {**fields, "keys": keys, "us_per_batch": us, "ns_per_row": us * 1e3 / keys,
            "bytes": nbytes, "gb_per_s": nbytes / us / 1e3}
