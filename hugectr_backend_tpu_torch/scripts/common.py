"""Shared pieces of the benchmark programs: the Criteo-Kaggle cardinalities
and their split into the three lookup kinds, the synthetic tables, the Zipf
keys, the tile-padded arena of the tiny tables, the CUDA-graph timers (a
batch of calls, and the slope over chained iterations), the eager timer,
the card's name and power limit, its published peak rates, and the
interaction kernels' bar against their plain versions.

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
# The 26 Criteo-Kaggle categorical cardinalities (C1..C26), uncapped.
CRITEO_CARDS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
]
# The same tables split as the JAX package's scripts/microbench_true.py and
# microbench_overlap.py split them: the 8 past 65,536 rows (BIG_CARDS, the
# solo group) and the 18 others (SMALL_CARDS); and the 14 one-hot members,
# the tables of at most 4,096 rows with their default row (OH_CARDS, as
# scripts/microbench_oh_fused.py and microbench_int8_onehot.py list them).
BIG_CARDS = [10131227, 2202608, 8351593, 5461306, 7046547, 286181, 142572,
             93145]
SMALL_CARDS = [1460, 583, 305, 24, 12517, 633, 3, 5683, 3194, 27, 14992, 10,
               5652, 2173, 4, 18, 15, 105]
OH_CARDS = [1460, 583, 305, 24, 633, 3, 3194, 27, 10, 2173, 4, 18, 15, 105]
# The 16 Criteo-Kaggle tables under 6k rows, the one-hot group of both
# microbenchmarks.
TINY_CARDS = [1460, 583, 305, 24, 633, 3, 5683, 3194, 27, 10, 5652, 2173, 4,
              18, 15, 105]
#: The interaction kernels (K2, K3, K4) against their plain versions: both
#: round z to bf16 and differ only in the order of the f32 sums, so rtol
#: RTOL with atol 1e-6 * max|z|^2 (where a sum cancels).
RTOL = 1e-5


def grouping(cards):
    """The production grouping policy (``ps/parameter_server.py``): ->
    (one-hot, arena, solo) table indices: tables of at most
    ``onehot_member_max_rows()`` rows with the default row, then those of at
    most ``arena_member_max_rows()`` rows, then the rest."""
    from hugectr_backend_tpu_torch.ps.parameter_server import (
        arena_member_max_rows,
        onehot_member_max_rows,
    )

    oh = [t for t, c in enumerate(cards) if c + 1 <= onehot_member_max_rows()]
    ar = [t for t, c in enumerate(cards)
          if c + 1 > onehot_member_max_rows() and c <= arena_member_max_rows()]
    big = [t for t, c in enumerate(cards) if c > arena_member_max_rows()]
    return oh, ar, big


def arena_layout(cards, align: int = 1):
    """Member blocks of ``card + 1`` rows padded to ``align``-row multiples
    (one-hot members to 128 rows, as production's arena views). -> (offsets
    [n + 1], total rows)."""
    blocks = [-(-(c + 1) // align) * align for c in cards]
    off = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int64)
    return off, int(off[-1])


def gen_scales(rows: int, device) -> torch.Tensor:
    """The device scales of :func:`gen_flat`'s rows: [rows] f32."""
    i = torch.arange(rows, dtype=torch.int32, device=device)
    return 0.01 + (i % 50).float() * 0.001


def gen_flat(rows: int, device) -> "tuple[torch.Tensor, torch.Tensor]":
    """-> (values [rows, DIM] int8, scales [rows] f32), built on ``device``
    (a multi-GB table never crosses from the host)."""
    i = torch.arange(rows, dtype=torch.int32, device=device)
    v = ((i * 131) % 255 - 127).to(torch.int8)
    values = v[:, None].expand(rows, DIM).contiguous()
    return values, gen_scales(rows, device)


def host_scale(i):
    """The host mirror of :func:`gen_scales` at rows ``i`` (f32, one
    multiply then one add)."""
    return np.float32(0.01) + (np.asarray(i) % 50).astype(np.float32) * np.float32(0.001)


def bf16_round(x) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32: what a
    bf16 cast on the card stores. Finite inputs."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


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


def zmax(feats) -> float:
    """max |z| over the interaction's rows, z rounded to bf16."""
    return max(float(f.to(torch.bfloat16).float().abs().max()) for f in feats if f.numel())


def interaction_within(got, want, zm: float) -> "tuple[bool, float]":
    """An interaction kernel's output against its plain version's: -> (every
    value within rtol RTOL and atol 1e-6 * zm^2, the largest |difference|)."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= 1e-6 * zm * zm + RTOL * want.float().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def rel_err(got, want) -> float:
    """max |got - want| / max |want| in f64, of arrays or tensors (on any
    device)."""
    got = np.asarray(torch.as_tensor(got).detach().float().cpu(), np.float64)
    want = np.asarray(torch.as_tensor(want).detach().float().cpu(), np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def timed_line(keys: int, us: float, nbytes: float, **fields) -> dict:
    """One result: µs per batch, ns per looked-up row, bytes moved and the
    rate they were moved at."""
    return {**fields, "keys": keys, "us_per_batch": us, "ns_per_row": us * 1e3 / keys,
            "bytes": nbytes, "gb_per_s": nbytes / us / 1e3}
