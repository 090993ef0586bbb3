"""Headline benchmark of the port: the Criteo-Kaggle DLRM's int8 embedding
lookup and fused dense forward on one CUDA card, through the production
access-path mix, at the uncapped cardinalities.

Port of the JAX package's ``bench.py``. Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

with every key of the JAX script's line, and a few of its own (``*_eager_us``,
``bump_us``, ``max_memory_allocated_gb``, the build time of the host
translation's index).

Workload, as there: the reference's CI model, DLRM over Criteo (26
categorical features, one key a table a sample) with the REAL Criteo-Kaggle
per-feature cardinalities (26 tables, 3 .. 10,131,227 rows, 33.76M rows x
128 int8, 4.32 GB), row-quantized int8 with f32 scales, Zipf(1.05) keys. The
tables are generated on the card from the closed form of
``scripts/common.gen_flat`` (row r: ``(r * 131) % 255 - 127``, scale
``0.01 + (r % 50) * 0.001``), so the truth of any slot is known on the host.
The production grouping (``ps/parameter_server.py``'s policy): 14 tables of
at most 4,095 rows in a one-hot arena (members padded to 128 rows), 4 of at
most 65,536 rows in an arena with device scales, 8 "solo" tables with
per-key scales gathered on the host. All 26 tables go to K1 in one launch
(``gather_dequant_groups``); the fused variants hand the rows to the DLRM as
chunked ``EmbParts``: ``f32`` folds the one-hot group into K3 (the
production default), ``f32_twostage`` looks it up in K1 and runs K2,
``bf16cast`` is ``compute_dtype=bf16`` (K3 with bf16 in and out),
``int8`` / ``fp8`` weight-only dense layers and ``w8a8`` (K5 in all 8).

TIMING on the card. Each iteration's slots are bumped by a value computed
from the previous iteration's output on the card (no host sync), so no
iteration can be skipped or served from a repeat: the low 16 bits of the
first output element's bit pattern, plus one, added to each slot's offset
in its table modulo the table's rows (defined for every value, NaN and inf
included; ``bump_us`` is its own device time). Two numbers, each under its
own name:

- device µs a batch: ``per_graph`` iterations (the lookup, the dense
  forward, the bump written into the static slot buffers) captured in one
  CUDA graph, replayed for ``IT_LO`` and ``IT_HI`` iterations, timed with
  CUDA events; the slope. The JAX keys (``batch_latency_us``,
  ``fused_dlrm_*_batch_latency_us``, ``din_pooled_batch_latency_us`` and the
  rates derived from them) carry it. On the CPU they are null.
- eager µs a batch (``*_eager_us``): the same iteration launched from
  Python without a graph, host clock to ``torch.cuda.synchronize()``,
  median over ``EAGER_ITERS``: what a serving call pays without CUDA graphs.

Besides: the host translation of a 26-table request over the uncapped
tables' native indexes (the index build timed apart), the DRAM / SSD tier
latency (interleaved 9-round protocol), and two HTTP stages (26 tables
capped at 20,000 rows, 64-sample binary requests from 8 clients, and a
1,250,000-row table at batch 256 from 4). Their clients are threads of this
process, as in the JAX script, so their p50 includes the interpreter lock
held by the clients' HTTP threads.

Each device stage checks itself: the first iteration's rows bit-exact
against the closed-form truth (K1 once per iteration on the card), the fold
against the two-stage path (logits rel < 5e-3), every variant's first 64
logits against the same model on the CPU (``VARIANT_TOL``), the launch counts
of one forward, and the DIN pool against the host's. A failed check raises.

Baseline: 1.0e9 vectors/s, the JAX script's A100 HPS reference point (an
A100 sustains roughly 1e9 random 512 B row reads/s through the HPS GPU
cache); ``vs_baseline`` divides by it. ``HPS_BENCH_SMOKE=1`` (read at call
time) takes the JAX script's smoke sizes; it never changes the device.

    python3 -m hugectr_backend_tpu_torch.bench [--device cpu] [--seconds S] [--out FILE]
    HPS_BENCH_SMOKE=1 python3 -m hugectr_backend_tpu_torch.bench --device cpu
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass

import numpy as np
import torch

from hugectr_backend_tpu_torch.scripts.common import (
    CRITEO_CARDS,
    arena_layout,
    card_info,
    eager_us,
    flat_truth,
    gen_flat,
    grouping,
    host_scale,
    rel_err,
    slope_us,
)
from hugectr_backend_tpu_torch.tiers.hbm import default_device

DIM = 128
NUM_DENSE = 13
BOTTOM = (512, 256, DIM)
TOP = (1024, 1024, 512, 256, 1)
BASELINE_VECTORS_PER_S = 1.0e9  # the JAX script's A100 HPS reference point
VARIANTS = ("f32", "f32_twostage", "bf16cast", "int8", "fp8", "w8a8")
EAGER_ITERS = 20
REL_FOLD = 5e-3  # fold vs two-stage logits (the JAX package's bar)
#: Each variant's first 64 logits on the card against the same model on the
#: CPU, |delta| / max|logit|: f32 sums in another order (f32 and the
#: weight-only formats, whose product is an f32 one); w8a8, where one ulp
#: can move a row's int8 quantization by a step; bf16, two bf16 ulps at
#: each of the 8 layers and one at the interaction, compounded
#: ((1 + 2^-7)^17 - 1).
VARIANT_TOL = {"f32": 1e-3, "f32_twostage": 1e-3, "bf16cast": (1 + 2.0 ** -7) ** 17 - 1,
               "int8": 1e-3, "fp8": 1e-3, "w8a8": 1e-2}
N_REF = 64  # samples held against the CPU


@dataclass(frozen=True)
class Sizes:
    cards: tuple
    batch: int
    small_batch: int
    it_lo: int
    it_hi: int
    ab_rounds: int
    din_rows: int
    din_b: int
    din_s: int


def sizes() -> Sizes:
    """The run's sizes: the JAX script's, or its smoke reductions under
    ``HPS_BENCH_SMOKE`` (read now, at call time)."""
    if os.environ.get("HPS_BENCH_SMOKE"):
        return Sizes(tuple(min(c, 60_000) for c in CRITEO_CARDS), 128, 64, 4, 12, 2,
                     20_000, 64, 8)
    return Sizes(tuple(CRITEO_CARDS), 4096, 1024, 64, 320,
                 int(os.environ.get("HPS_FUSED_AB_ROUNDS", "5")), 1_000_000, 1024, 64)


def smoke() -> bool:
    return bool(os.environ.get("HPS_BENCH_SMOKE"))


# --------------------------------------------------------------- the lookup


class CriteoTables:
    """The 26 tables on ``device`` in the production grouping, generated there
    from ``gen_flat``'s closed form: the one-hot arena (its scales ride on
    the host), the arena with device scales, the solo tables (scales on the
    host)."""

    def __init__(self, cards, device):
        self.cards = tuple(cards)
        self.device = torch.device(device)
        self.oh_idx, self.ar_idx, self.big_idx = grouping(self.cards)
        self.oh_cards = [self.cards[t] for t in self.oh_idx]
        self.ar_cards = [self.cards[t] for t in self.ar_idx]
        self.big_cards = [self.cards[t] for t in self.big_idx]
        self.oh_off, oh_total = arena_layout(self.oh_cards, align=128)
        self.ar_off, ar_total = arena_layout(self.ar_cards)
        self.oh_vals, _ = gen_flat(oh_total, self.device)
        self.ar_vals, self.ar_scales = gen_flat(ar_total, self.device)
        self.big_vals = [gen_flat(c, self.device)[0] for c in self.big_cards]
        # Padded member sizes, what production's prepare_lookup passes.
        self.oh_members = tuple((int(self.oh_off[i]), int(self.oh_off[i + 1] - self.oh_off[i]))
                                for i in range(len(self.oh_cards)))

    @property
    def nbytes(self) -> int:
        ts = [self.oh_vals, self.ar_vals, self.ar_scales, *self.big_vals]
        return sum(t.numel() * t.element_size() for t in ts)

    def layout(self) -> str:
        return (f"criteo-kaggle {len(self.cards)} tables x {DIM}d int8+f32 scales: "
                f"{len(self.oh_idx)} one-hot arena + {len(self.ar_idx)} arena gather + "
                f"{len(self.big_idx)} solo gather w/ host scales (production policy), "
                "every group in one K1 launch")


def make_slots(seed: int, cards, off, batch: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return np.concatenate([off[i] + (r.zipf(1.05, batch) % c)
                           for i, c in enumerate(cards)]).astype(np.int64)


def args_for(tables: CriteoTables, seed: int, batch: int):
    """The JAX script's ``args_for``: -> (one-hot slots, arena slots, [solo
    slots], one-hot scales, [solo scales]), numpy."""
    oh_np = make_slots(seed, tables.oh_cards, tables.oh_off, batch)
    ar_np = make_slots(seed + 7000, tables.ar_cards, tables.ar_off, batch)
    r = np.random.default_rng(seed + 9000)
    big_np = [r.zipf(1.05, batch) % c for c in tables.big_cards]
    return oh_np, ar_np, big_np, host_scale(oh_np), [host_scale(s) for s in big_np]


class LookupState:
    """One batch size's static device buffers over ``tables``: the packed
    slots of every group (one-hot, arena, solo in turn), their per-key
    scales, and what the bump needs (each slot's offset in its table, the
    table's base and rows)."""

    def __init__(self, tables: CriteoTables, batch: int):
        self.t, self.batch = tables, batch
        dev = tables.device
        n_oh, n_ar, n_big = len(tables.oh_cards), len(tables.ar_cards), len(tables.big_cards)
        b = batch
        self.vals = [tables.oh_vals, tables.ar_vals, *tables.big_vals]
        self.dscales = [None, tables.ar_scales] + [None] * n_big
        self.meta_all = (("onehot", tuple(o for o, _ in tables.oh_members),
                          tuple(s for _, s in tables.oh_members), (b,) * n_oh),
                         ("gather",)) + (("gather",),) * n_big
        self.meta_fold = (("skip",),) + self.meta_all[1:]
        bounds = [(0, n_oh * b), (n_oh * b, (n_oh + n_ar) * b)]
        bounds += [((n_oh + n_ar + j) * b, (n_oh + n_ar + j + 1) * b) for j in range(n_big)]
        self.slot_bounds = tuple(bounds)
        sc = [(0, n_oh * b), None]
        sc += [((n_oh + j) * b, (n_oh + j + 1) * b) for j in range(n_big)]
        self.scin_bounds = tuple(sc)
        bases = np.concatenate(
            [np.repeat(tables.oh_off[:-1], b), np.repeat(tables.ar_off[:-1], b),
             np.zeros(n_big * b, np.int64)]).astype(np.int32)
        mods = np.repeat(np.asarray(tables.oh_cards + tables.ar_cards + tables.big_cards,
                                    np.int32), b)
        self.bases = torch.from_numpy(bases).to(dev)
        self.mods = torch.from_numpy(mods).to(dev)
        self.slots = torch.zeros(bases.shape[0], dtype=torch.int32, device=dev)
        self.rel = torch.zeros_like(self.slots)
        self.scin = torch.zeros((n_oh + n_big) * b, dtype=torch.float32, device=dev)
        self.host = None
        self.load(0)

    def load(self, seed: int) -> None:
        """Write the slot set and scales of ``seed`` into the static buffers."""
        oh, ar, big, oh_sc, big_sc = args_for(self.t, seed, self.batch)
        slots = np.concatenate([oh, ar, *big]).astype(np.int32)
        self.host = slots
        self.slots.copy_(torch.from_numpy(slots))
        self.rel.copy_(self.slots - self.bases)
        self.scin.copy_(torch.from_numpy(np.concatenate([oh_sc, *big_sc]).astype(np.float32)))

    def lookup(self, fold: bool = False):
        """Every group's rows in ONE K1 launch (the one-hot group skipped
        with ``fold``). -> per group [n, D] f32 (None for the skipped)."""
        from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant_groups

        return gather_dequant_groups(self.vals, self.dscales, self.slots, self.scin,
                                     self.meta_fold if fold else self.meta_all,
                                     self.slot_bounds, self.scin_bounds)

    def emb_parts(self, outs, fold: bool):
        """The lookup's rows as the DLRM's chunked features, part-major (the
        one-hot group first, in the kernel with ``fold``, then the arena,
        then each solo table)."""
        from hugectr_backend_tpu_torch.ops.fused_interaction import EmbParts

        t, b = self.t, self.batch
        n_oh = len(t.oh_cards)
        parts, fmap, oh = [], [], None
        if fold:
            oh = (t.oh_vals, self.slots[:n_oh * b].view(n_oh, b),
                  self.scin[:n_oh * b].view(n_oh, b), t.oh_members)
        elif n_oh:
            parts.append(outs[0].view(n_oh, b, DIM))
            fmap += [(0, j) for j in range(n_oh)]
        if t.ar_cards:
            fmap += [(len(parts), j) for j in range(len(t.ar_cards))]
            parts.append(outs[1].view(len(t.ar_cards), b, DIM))
        for j in range(len(t.big_cards)):
            fmap.append((len(parts), 0))
            parts.append(outs[2 + j].view(1, b, DIM))
        return EmbParts(parts, fmap, b, oh=oh)

    def bump(self, x: torch.Tensor) -> None:
        """Advance every slot by a step taken from ``x``'s first element (the
        low 16 bits of its bit pattern, plus one), modulo its table's rows;
        on the device, no host sync."""
        step = x.reshape(-1)[:1].float().view(torch.int32).bitwise_and(0xFFFF).add_(1)
        self.rel.add_(step).remainder_(self.mods)
        torch.add(self.rel, self.bases, out=self.slots)

    def truth(self):
        """The closed-form rows of the loaded slot set's groups (numpy), each
        ``values * host_scale`` as K1 computes it for every kind."""
        return [flat_truth(self.host[a:b], "device") for a, b in self.slot_bounds]

    def ref_emb(self, n: int) -> np.ndarray:
        """The first ``n`` samples' features in the model's order, from the
        closed form: [n, 26, D] f32."""
        rows = [r.reshape(-1, self.batch, DIM)[:, :n] for r in self.truth()]
        return np.concatenate(rows, axis=0).transpose(1, 0, 2).copy()


# ------------------------------------------------------------- the variants


def make_model(num_tables: int, seed: int = 1):
    """The benchmark's f32 DLRM (512-256-128 / 1024-1024-512-256-1), Flax's
    initialisation from a seeded generator."""
    from hugectr_backend_tpu_torch.models.dlrm import DLRM

    model = DLRM(NUM_DENSE, num_tables, BOTTOM, TOP)
    model.init_flax_(torch.Generator().manual_seed(seed))
    return model.eval()


def make_variants(model):
    """The six dense variants of the JAX script (bench.py:809-816) on the
    f32 model's weights: -> {name: (model, fold)} (models on the CPU)."""
    from hugectr_backend_tpu_torch.models.dlrm import DLRM
    from hugectr_backend_tpu_torch.models.quant_dense import quantize_model_params

    args = (model.num_dense, model.num_tables, model.bottom_widths, model.top_widths)
    bf16 = DLRM(*args, compute_dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    out = {"f32": (model, True), "f32_twostage": (model, False), "bf16cast": (bf16.eval(), True)}
    for fmt in ("int8", "fp8", "w8a8"):
        q = DLRM(*args, quant_fmt=fmt)
        q.load_state_dict(quantize_model_params(model.state_dict(), fmt))
        out[fmt] = (q.eval(), True)
    return out


def variant_logits(state: LookupState, model, fold: bool, dense: torch.Tensor):
    """One fused forward: K1 over the groups, then the DLRM on the chunked
    rows (K3 with the fold, K2 without). -> logits [B] f32."""
    outs = state.lookup(fold)
    return model(dense, state.emb_parts(outs, fold))


def _counted(fn, dev):
    """-> (fn's result, the kernel launches it made)."""
    from hugectr_backend_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                 if v - before.get(k, 0)}


#: The kernels one forward of each variant launches on the card.
VARIANT_LAUNCHES = {
    "f32": {"gather_dequant": 1, "dot_interaction_oh_parts": 1},
    "f32_twostage": {"gather_dequant": 1, "dot_interaction_parts": 1},
    "bf16cast": {"gather_dequant": 1, "dot_interaction_oh_parts": 1},
    "int8": {"gather_dequant": 1, "dot_interaction_oh_parts": 1},
    "fp8": {"gather_dequant": 1, "dot_interaction_oh_parts": 1},
    "w8a8": {"gather_dequant": 1, "dot_interaction_oh_parts": 1,
             "w8a8_dense": len(BOTTOM) + len(TOP)},
}


# ------------------------------------------------------------------ stages


def lookup_stage(tables: CriteoTables, batch: int, sz: Sizes, dev) -> dict:
    """The headline lookup at ``batch``: the first iteration checked against
    the closed form, then device (graph slope) and eager µs a batch."""
    st = LookupState(tables, batch)
    outs, launched = _counted(st.lookup, dev)
    for g, (got, want) in enumerate(zip(outs, st.truth())):
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"lookup at batch {batch}, group {g}: != the closed form")
    if dev.type == "cuda" and launched != {"gather_dequant": 1}:
        raise AssertionError(f"lookup at batch {batch}: launches {launched}, expected one K1")

    def iteration():
        st.bump(st.lookup()[0])

    out = {"eager_us": None, "us": None}
    for _ in range(2):
        iteration()
    out["eager_us"] = eager_us(iteration, EAGER_ITERS)
    if dev.type == "cuda":
        best = []
        for seed in (1, 2, 3):
            st.load(seed)
            best.append(slope_us(iteration, sz.it_lo, sz.it_hi))
        out["us"] = min(best)
        out["bump_us"] = slope_us(lambda: st.bump(st.scin), sz.it_lo, sz.it_hi)
    return out


def fused_stage(tables: CriteoTables, sz: Sizes, dev) -> dict:
    """The six dense variants at the headline batch: checks, then
    interleaved round-robin slopes (median over ``ab_rounds`` and the spread)
    and eager µs."""
    batch = sz.batch
    st = LookupState(tables, batch)
    variants = make_variants(make_model(len(tables.cards)))
    rng = np.random.default_rng(0)
    dense_np = rng.standard_normal((batch, NUM_DENSE)).astype(np.float32)
    dense = torch.from_numpy(dense_np).to(dev)
    ref_emb = torch.from_numpy(st.ref_emb(N_REF))
    ref_dense = torch.from_numpy(dense_np[:N_REF])
    on_dev = {name: (m.to(dev), fold) for name, (m, fold) in variants.items()}
    checks, logits = {}, {}
    with torch.inference_mode():
        for name, (m, fold) in on_dev.items():
            got, launched = _counted(lambda: variant_logits(st, m, fold, dense), dev)
            if dev.type == "cuda" and launched != VARIANT_LAUNCHES[name]:
                raise AssertionError(f"fused {name}: launches {launched}, expected "
                                     f"{VARIANT_LAUNCHES[name]}")
            got = got.float().cpu().numpy()
            if got.shape != (batch,) or not np.isfinite(got).all():
                raise AssertionError(f"fused {name}: logits not finite of shape ({batch},)")
            logits[name] = got
            cpu_model = variants[name][0] if dev.type == "cpu" else _cpu_copy(m)
            want = cpu_model(ref_dense, ref_emb).float().numpy()
            rel = rel_err(got[:N_REF], want)
            if rel > VARIANT_TOL[name]:
                raise AssertionError(f"fused {name}: first {N_REF} logits vs the CPU "
                                     f"|delta|/max|logit| {rel} > {VARIANT_TOL[name]}")
            checks[name] = rel
        fold_rel = rel_err(logits["f32"], logits["f32_twostage"])
        if fold_rel >= REL_FOLD:
            raise AssertionError(f"fold vs two-stage logits rel {fold_rel}")

        def iteration(m, fold):
            def it():
                st.bump(variant_logits(st, m, fold, dense))
            return it

        its = {name: iteration(m, fold) for name, (m, fold) in on_dev.items()}
        eager = {}
        for name, it in its.items():
            it()
            eager[name] = eager_us(it, EAGER_ITERS)
        samples = {name: [] for name in its}
        if dev.type == "cuda":
            for rd in range(sz.ab_rounds):
                for name, it in its.items():
                    st.load(100 + 13 * rd)
                    samples[name].append(slope_us(it, sz.it_lo, sz.it_hi))
    med = {n: (float(np.median(s)) if s else None) for n, s in samples.items()}
    spread = {n: (round((max(s) - min(s)) / max(med[n], 1e-9), 3) if s else None)
              for n, s in samples.items()}
    return {"median_us": med, "spread": spread, "eager_us": eager, "cpu_rel": checks,
            "fold_vs_twostage_rel": fold_rel, "samples_us": samples}


def _cpu_copy(model):
    import copy

    return copy.deepcopy(model).to("cpu")


def din_stage(sz: Sizes, dev) -> dict:
    """The DIN-style pooled lookup (BASELINE config 4): keys [B, S] Zipf,
    masked mean pooling after K1 (``serving/pooled._pooled_gather``), a
    solo table with host-gathered scales; checked against the host's pool
    of the closed-form rows (f32 sums in another order: rel 1e-5)."""
    from hugectr_backend_tpu_torch.serving.pooled import _pooled_gather

    rows, b, s = sz.din_rows, sz.din_b, sz.din_s
    values, _ = gen_flat(rows, dev)  # the solo policy: scales ride on the host
    r = np.random.default_rng(1)
    slots_np = (r.zipf(1.05, b * s) % rows).astype(np.int32)
    seq_np = r.integers(1, s + 1, b).astype(np.int32)
    slots = torch.from_numpy(slots_np.copy()).to(dev)
    seq = torch.from_numpy(seq_np).to(dev)
    scin = torch.from_numpy(host_scale(slots_np)).to(dev)
    mods = torch.tensor([rows], dtype=torch.int32, device=dev)

    def pooled():
        return _pooled_gather(values, None, slots, seq, b, s, "mean", scin=scin)

    got = pooled().cpu().numpy()
    truth = flat_truth(slots_np, "device").reshape(b, s, DIM)
    mask = (np.arange(s)[None, :] < seq_np[:, None]).astype(np.float32)
    want = (truth * mask[..., None]).sum(1) / np.maximum(seq_np, 1)[:, None].astype(np.float32)
    rel = rel_err(got, want)
    if rel > 1e-5:
        raise AssertionError(f"DIN pooled lookup vs the host's pool: rel {rel}")

    def iteration():
        out = pooled()
        step = out.reshape(-1)[:1].view(torch.int32).bitwise_and(0xFFFF).add_(1)
        slots.add_(step).remainder_(mods)

    iteration()
    res = {"eager_us": eager_us(iteration, EAGER_ITERS), "us": None, "host_rel": rel,
           "rows": rows, "b": b, "s": s}
    if dev.type == "cuda":
        res["us"] = min(slope_us(iteration, sz.it_lo, sz.it_hi) for _ in range(3))
    return res


def tier_latency_stage() -> dict:
    """Bulk-read latency of the DRAM and SSD tiers for a 4,096-key batch
    (the reference's "CPU memory database: us ~ ms" / "persistent database:
    ms ~ s" rows). Host only. Interleaved rounds with per-round key sets,
    min of 2 a round, median and (max - min) / median."""
    from hugectr_backend_tpu_torch.config.params import PersistentDatabaseParams
    from hugectr_backend_tpu_torch.tiers.dram import make_dram_tier
    from hugectr_backend_tpu_torch.tiers.ssd import SsdKVTier

    sm = smoke()
    rows, dim, nq = (50_000, 32, 512) if sm else (2_000_000, 32, 4096)
    ssd_rows = 20_000 if sm else 300_000
    rng = np.random.default_rng(0)
    dram = make_dram_tier()
    dram.create_table("hps_et.bench.t", dim)
    keys = rng.choice(np.int64(1) << 40, size=rows, replace=False)
    vecs = rng.standard_normal((rows, dim)).astype(np.float32)
    for i in range(0, rows, 250_000):
        dram.insert("hps_et.bench.t", keys[i:i + 250_000], vecs[i:i + 250_000])
    with tempfile.TemporaryDirectory(prefix="hps_bench_ssd_") as tmp:
        ssd = SsdKVTier(PersistentDatabaseParams(path=tmp))
        try:
            ssd.create_table("hps_et.bench.s", dim)
            for i in range(0, ssd_rows, 100_000):
                ssd.insert("hps_et.bench.s", keys[i:i + 100_000], vecs[i:i + 100_000])
            rounds = 3 if sm else 9
            samples = {"dram": [], "ssd": []}
            for _ in range(rounds):
                qk = keys[rng.integers(0, rows, nq)]
                qs = keys[rng.integers(0, ssd_rows, nq)]
                for name, tier, tag, q in (("dram", dram, "hps_et.bench.t", qk),
                                           ("ssd", ssd, "hps_et.bench.s", qs)):
                    best = float("inf")
                    for _ in range(2):
                        t0 = time.perf_counter()
                        tier.query(tag, q)
                        best = min(best, time.perf_counter() - t0)
                    samples[name].append(best * 1e6)
        finally:
            ssd.close()
    dram_us = float(np.median(samples["dram"]))
    ssd_us = float(np.median(samples["ssd"]))
    return {
        "dram_tier_query_us": dram_us,
        "dram_tier_ns_per_key": dram_us * 1e3 / nq,
        "ssd_tier_query_us": ssd_us,
        "ssd_tier_ns_per_key": ssd_us * 1e3 / nq,
        "tier_query_keys": nq,
        "tier_protocol": f"interleaved x{rounds} rounds, min-of-2 per round, median; "
                         "spread=(max-min)/median",
        "tier_spread": {n: (max(s) - min(s)) / max(float(np.median(s)), 1e-9)
                        for n, s in samples.items()},
    }


def host_translate_stage(batch: int, cards) -> dict:
    """Key -> slot translation of a full 26-table request (sparse int64 keys)
    on the native indexes of the tables' sizes, every table in one batch
    call on the native pool (``tiers/hbm.translate_indexes_batch``); the
    index build is timed apart. Median of 9 rounds' minima of 3."""
    from hugectr_backend_tpu_torch.tiers.hbm import KeyIndex, translate_indexes_batch

    rng = np.random.default_rng(9)
    idxs, batches = [], []
    t0 = time.perf_counter()
    for c in cards:
        keys = np.sort(rng.choice(c * 4 + 8, size=c, replace=False).astype(np.int64))
        idx, _ = KeyIndex.build(keys)
        idxs.append(idx)
        batches.append(keys[rng.zipf(1.05, batch) % c])
    build_s = time.perf_counter() - t0
    want = [idx.search(k) for idx, k in zip(idxs, batches)]
    got = translate_indexes_batch(idxs, batches)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("host translation != the searchsorted lookup")
    rounds = []
    for _ in range(9):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            translate_indexes_batch(idxs, batches)
            best = min(best, time.perf_counter() - t0)
        rounds.append(best)
    best = float(np.median(rounds))
    cpus = multiprocessing.cpu_count()
    return {
        "host_translate_us": best * 1e6,
        "host_translate_spread": (max(rounds) - min(rounds)) / max(best, 1e-12),
        "host_translate_ns_per_key": best * 1e9 / (batch * len(cards)),
        "host_translate_cpus": cpus,
        "host_translate_build_s": build_s,
        "host_translate_rows": int(sum(cards)),
        "host_translate_note": "native static-hash batch translate, all tables parallel on "
                               f"the pool; scales with host cores (this host: {cpus})",
    }


def _post_binary(url: str, keys: np.ndarray, numkeys, timeout: float = 300) -> None:
    """One KServe-v2 binary-tensor request (what perf_analyzer sends)."""
    kraw = np.ascontiguousarray(keys, "<i8").tobytes()
    nraw = np.asarray(numkeys, "<i4").tobytes()
    header = json.dumps({
        "inputs": [
            {"name": "KEYS", "datatype": "INT64", "shape": [keys.shape[0]],
             "parameters": {"binary_data_size": len(kraw)}},
            {"name": "NUMKEYS", "datatype": "INT32", "shape": [len(numkeys)],
             "parameters": {"binary_data_size": len(nraw)}},
        ],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}}],
    }).encode()
    r = urllib.request.urlopen(urllib.request.Request(
        url, data=header + kraw + nraw,
        headers={"Content-Type": "application/octet-stream",
                 "Inference-Header-Content-Length": str(len(header))}), timeout=timeout)
    r.read()


def _drive(call, conc: int, duration: float):
    """``conc`` client threads calling ``call(cid, i)`` for ``duration`` s.
    -> (sorted latencies in s, wall s)."""
    lat, lock, stop = [], threading.Lock(), threading.Event()

    def client(cid):
        i = cid
        while not stop.is_set():
            t0 = time.perf_counter()
            if call(cid, i):
                with lock:
                    lat.append(time.perf_counter() - t0)
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(conc)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(duration)
    stop.set()
    for th in threads:
        th.join(timeout=60)
    wall = time.perf_counter() - t_start
    with lock:
        return np.sort(np.asarray(lat)), wall


def _pct(ls, q: float) -> float:
    return float(ls[min(int(ls.size * q), ls.size - 1)]) * 1e3


def _batcher_split(model: str):
    """-> a function of no argument giving the batcher's mean software and
    dispatch µs a merged batch, and the batches, since this call (the
    window's own: the registry is the process's)."""
    from hugectr_backend_tpu_torch.serving import metrics as m

    h = (m.BATCH_SW_SECONDS, m.BATCH_DISPATCH_SECONDS)
    s0 = [(x.sum(model=model), x.count(model=model)) for x in h]

    def since():
        d = [(x.sum(model=model) - s, x.count(model=model) - c) for x, (s, c) in zip(h, s0)]
        return ([ds / dc * 1e6 if dc else None for ds, dc in d], d[0][1])

    return since


def e2e_serving_stage(device=None, duration=None) -> dict:
    """A Criteo-shaped lookup model (26 tables capped at 20,000 rows, D 128)
    served over the HTTP front end on ``device``, 64-sample binary requests
    from 8 client threads of this process for ``duration`` s (10 by
    default), then the same over gRPC; the batcher's mean software and
    dispatch time per merged batch of the HTTP window."""
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
    from hugectr_backend_tpu_torch.serving.server import serve

    sm = smoke()
    cards = [min(c, 2_000 if sm else 20_000) for c in CRITEO_CARDS]
    if sm:
        cards = cards[:4]
    dur, conc = (2.0, 2) if sm else (10.0, 8)
    dur = dur if duration is None else duration
    n_t = len(cards)
    tmp = tempfile.TemporaryDirectory(prefix="hps_bench_e2e_")
    sparse_files, table_keys = [], []
    for i, c in enumerate(cards):
        tbl = make_synthetic_table(c, DIM, seed=i, deterministic_fn=False)
        write_sparse_model(f"{tmp.name}/t{i}", tbl.keys, tbl.vectors)
        sparse_files.append(f"{tmp.name}/t{i}")
        table_keys.append(tbl.keys)
    cfg = {"supportlonglong": True, "models": [{
        "model": "dlrm", "sparse_files": sparse_files, "dense_file": "",
        "network_file": "", "max_batch_size": 256,
        "embedding_vecsize_per_table": [DIM] * n_t,
        "maxnum_catfeature_query_per_table_per_sample": [1] * n_t,
        "default_value_for_each_table": [0.0] * n_t,
        "deployed_device_list": [0], "gpucache": True, "gpucacheper": 1.0}]}
    try:
        server = serve(ps_source=cfg, port=0, block=False, grpc_port=0, device=device)
    except BaseException:
        tmp.cleanup()
        raise
    try:
        url = f"http://127.0.0.1:{server.port}/v2/models/dlrm/infer"
        batch = 8 if sm else 64

        def req_keys(seed):
            r = np.random.default_rng(seed)
            return np.concatenate([k[r.zipf(1.05, batch) % k.shape[0]] for k in table_keys])

        keys_np = [req_keys(s) for s in range(32)]
        # Warm the pow2 merge buckets any concurrency mix lands on.
        r = np.random.default_rng(99)
        wb = batch
        while wb <= 256:
            _post_binary(url, np.concatenate([k[r.integers(0, k.shape[0], wb)]
                                              for k in table_keys]), [wb] * n_t)
            wb *= 2
        split = _batcher_split("dlrm")

        def http(cid, i):
            _post_binary(url, keys_np[i % len(keys_np)], [batch] * n_t, timeout=60)
            return True

        ls, wall = _drive(http, conc, dur)
        (sw_us, disp_us), batches = split()
        n = ls.size
        if n == 0:
            return {"e2e_error": "no completed requests"}
        out = {
            "e2e_http_qps": n / wall,
            "e2e_http_samples_per_s": n * batch / wall,
            "e2e_batch": batch,
            "e2e_concurrency": conc,
            "e2e_seconds": dur,
            "e2e_p50_ms": _pct(ls, 0.5),
            "e2e_p99_ms": _pct(ls, 0.99),
            "e2e_sw_overhead_us": sw_us,
            "e2e_dispatch_us": disp_us,
            "e2e_batches_executed": batches,
            "e2e_note": f"{n_t}-table lookup via HTTP binary tensors, clients as threads of "
                        "the server's process",
            "e2e_qps_disclaimer": "the clients are threads of the server's process, so the "
                                  "p50 and the batcher's software time include the "
                                  "interpreter lock held by the clients' HTTP threads; "
                                  "frontend_saturation (device stubbed) is the front end's "
                                  "software number",
        }
        out.update(_grpc_leg(server, keys_np, batch, n_t, conc, dur))
        return out
    finally:
        server.stop()
        tmp.cleanup()


def _grpc_leg(server, keys_np, batch: int, n_t: int, conc: int, dur: float) -> dict:
    """The same requests over KServe-v2 gRPC (perf_analyzer -i grpc)."""
    try:
        import grpc as grpc_mod

        from hugectr_backend_tpu_torch.serving import kserve_pb

        pb2 = kserve_pb.load()
    except ImportError as e:
        return {"e2e_grpc_error": repr(e)}
    channels = {}

    def call(cid, i):
        if cid not in channels:
            ch = grpc_mod.insecure_channel(f"127.0.0.1:{server.grpc.port}")
            channels[cid] = (ch, ch.unary_unary(
                f"/{kserve_pb.SERVICE_NAME}/ModelInfer",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb2.ModelInferResponse.FromString))
        keys = keys_np[i % len(keys_np)]
        req = pb2.ModelInferRequest(model_name="dlrm")
        ki = req.inputs.add()
        ki.name, ki.datatype = "KEYS", "INT64"
        ki.shape.append(keys.shape[0])
        ni = req.inputs.add()
        ni.name, ni.datatype = "NUMKEYS", "INT32"
        ni.shape.append(n_t)
        req.raw_input_contents.append(np.ascontiguousarray(keys, "<i8").tobytes())
        req.raw_input_contents.append(np.asarray([batch] * n_t, "<i4").tobytes())
        channels[cid][1](req, timeout=60)
        return True

    try:
        ls, wall = _drive(call, conc, dur)
    finally:
        for ch, _ in channels.values():
            ch.close()
    if ls.size == 0:
        return {"e2e_grpc_error": "no completed requests"}
    return {"e2e_grpc_qps": ls.size / wall, "e2e_grpc_samples_per_s": ls.size * batch / wall,
            "e2e_grpc_p50_ms": _pct(ls, 0.5), "e2e_grpc_p99_ms": _pct(ls, 0.99)}


def e2e_bigtable_stage(device=None, duration=None) -> dict:
    """One 1,250,000 x 32 table (the solo path with host scales) served over
    HTTP at batch 256 from 4 client threads for ``duration`` s (10 by
    default): the measured pipelined rate and the batcher's split."""
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
    from hugectr_backend_tpu_torch.serving.server import serve

    sm = smoke()
    rows, dim = (30_000, 16) if sm else (1_250_000, 32)
    dur, conc, batch = (2.0, 2, 16) if sm else (10.0, 4, 256)
    dur = dur if duration is None else duration
    tbl = make_synthetic_table(rows, dim, seed=5, deterministic_fn=False)
    tmp = tempfile.TemporaryDirectory(prefix="hps_bench_big_")
    write_sparse_model(f"{tmp.name}/t0", tbl.keys, tbl.vectors)
    cfg = {"supportlonglong": True, "models": [{
        "model": "big", "sparse_files": [f"{tmp.name}/t0"], "max_batch_size": 1024,
        "embedding_vecsize_per_table": [dim],
        "maxnum_catfeature_query_per_table_per_sample": [1],
        "deployed_device_list": [0], "gpucache": True, "gpucacheper": 1.0}]}
    try:
        server = serve(ps_source=cfg, port=0, block=False, grpc_port=None, device=device)
    except BaseException:
        tmp.cleanup()
        raise
    try:
        url = f"http://127.0.0.1:{server.port}/v2/models/big/infer"
        rng = np.random.default_rng(11)
        reqs = [tbl.keys[rng.zipf(1.05, batch) % rows] for _ in range(32)]
        wb = batch
        while wb <= batch * conc:
            keys = tbl.keys[rng.integers(0, rows, wb)]
            _post_binary(url, keys, [keys.shape[0]])
            wb *= 2
        split = _batcher_split("big")

        def http(cid, i):
            _post_binary(url, reqs[i % len(reqs)], [batch])
            return True

        ls, wall = _drive(http, conc, dur)
        (sw_us, disp_us), batches = split()
        if ls.size == 0:
            return {"e2e_bigtable_error": "no completed requests"}
        return {
            "e2e_bigtable_rows": rows,
            "e2e_bigtable_qps": ls.size / wall,
            "e2e_bigtable_vectors_per_s_measured": ls.size * batch / wall,
            "e2e_bigtable_p50_ms": _pct(ls, 0.5),
            "e2e_bigtable_p99_ms": _pct(ls, 0.99),
            "e2e_bigtable_sw_overhead_us": sw_us,
            "e2e_bigtable_dispatch_us": disp_us,
            "e2e_bigtable_batches_executed": batches,
            "e2e_bigtable_note": "solo-gather path under serving concurrency; measured "
                                 "pipelined run",
        }
    finally:
        server.stop()
        tmp.cleanup()


# -------------------------------------------------------------------- run


def _per_s(n: float, us):
    return None if us is None else n / us * 1e6


def run(device=None, seconds=None, emit=None) -> dict:
    """Every stage on ``device`` (the card unless ``"cpu"``). ``seconds``: the
    HTTP stages' windows (the JAX script's 10 by default). -> the JSON line
    (also passed to ``emit``; printed by default). Raises on a failed
    check."""
    dev = default_device(device)
    sz = sizes()
    n_tables = len(sz.cards)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the allocator's stats exist once it has allocated
        torch.cuda.reset_peak_memory_stats(dev)
    info = card_info(dev)
    t0 = time.perf_counter()
    tables = CriteoTables(sz.cards, dev)
    head = lookup_stage(tables, sz.batch, sz, dev)
    small = lookup_stage(tables, sz.small_batch, sz, dev)
    fused = fused_stage(tables, sz, dev)
    tables_gb = tables.nbytes / 1e9
    layout = tables.layout()
    oh_n, ar_n, big_n = len(tables.oh_idx), len(tables.ar_idx), len(tables.big_idx)
    del tables
    din = din_stage(sz, dev)
    device_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tier = tier_latency_stage()
    host = host_translate_stage(sz.batch, sz.cards)
    us_head = head["us"]
    host["sustained_vectors_per_s"] = (
        None if us_head is None
        else sz.batch * n_tables / max(host["host_translate_us"], us_head) * 1e6)
    e2e = e2e_serving_stage(dev if dev.type == "cpu" else None, seconds)
    e2e.update(e2e_bigtable_stage(dev if dev.type == "cpu" else None, seconds))
    med = fused["median_us"]
    us_e2e = med["f32"]
    dense_variants = {}
    for name in VARIANTS[1:]:
        dense_variants[f"fused_dlrm_{name}_dense_samples_per_s"] = _per_s(sz.batch, med[name])
        dense_variants[f"fused_dlrm_{name}_dense_batch_latency_us"] = med[name]
        dense_variants[f"fused_dlrm_{name}_eager_us"] = fused["eager_us"][name]
    dense_variants["fused_ab_protocol"] = (
        f"interleaved round-robin x{sz.ab_rounds}, median slope; in-session spread "
        "(max-min)/median per variant below")
    dense_variants["fused_ab_spread"] = fused["spread"]
    vectors_per_s = _per_s(sz.batch * n_tables, us_head)
    line = {
        "metric": "criteo_dlrm_int8_lookup_vectors_per_s_per_chip",
        "value": vectors_per_s,
        "unit": "vectors/s",
        "vs_baseline": None if vectors_per_s is None else vectors_per_s / BASELINE_VECTORS_PER_S,
        "batch_latency_us": us_head,
        "batch_eager_us": head["eager_us"],
        "bump_us": head.get("bump_us"),
        "batch1024_latency_us": small["us"],
        "batch1024_eager_us": small["eager_us"],
        "batch1024_vectors_per_s": _per_s(sz.small_batch * n_tables, small["us"]),
        "fused_dlrm_e2e_samples_per_s": _per_s(sz.batch, us_e2e),
        "fused_dlrm_batch_latency_us": us_e2e,
        "fused_dlrm_eager_us": fused["eager_us"]["f32"],
        "fused_dlrm_dense_delta_us": None if us_e2e is None else us_e2e - us_head,
        **dense_variants,
        "fused_fold_vs_twostage_rel": fused["fold_vs_twostage_rel"],
        "fused_vs_cpu_rel": fused["cpu_rel"],
        "din_pooled_vectors_per_s": _per_s(din["b"] * din["s"], din["us"]),
        "din_pooled_samples_per_s": _per_s(din["b"], din["us"]),
        "din_pooled_batch_latency_us": din["us"],
        "din_pooled_eager_us": din["eager_us"],
        "din_pooled_shape": f"[{din['b']}, {din['s']}] keys, {din['rows']}-row int8 table, "
                            "masked mean, host-side scales (solo policy)",
        **tier,
        **host,
        "batch": sz.batch,
        "num_tables": n_tables,
        "table_gb": tables_gb,
        "groups": {"onehot": oh_n, "arena": ar_n, "solo": big_n},
        "layout": layout,
        "timing": (f"device: slope over {sz.it_lo}->{sz.it_hi} iterations replayed from CUDA "
                   "graphs, each iteration's slots bumped on the card from its output; "
                   f"eager: median of {EAGER_ITERS} iterations launched from Python, host "
                   "clock to a synchronize" if dev.type == "cuda" else
                   "CPU run: device keys null; eager keys are the CPU's host clock"),
        "device": info["device"],
        "max_memory_allocated_gb": peak_gb,
        "device_stages_s": device_s,
        **e2e,
    }
    (emit or _print)(line)
    return line


def _print(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda[:i] (default) or cpu")
    p.add_argument("--seconds", type=float, default=None,
                   help="the HTTP stages' windows (default 10, 2 under HPS_BENCH_SMOKE)")
    p.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = p.parse_args(argv)

    def emit(line):
        _print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    run(args.device, args.seconds, emit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
