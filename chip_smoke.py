#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. The card (name, power limit) and the kernel build (``nvcc``, one process
   per ``csrc/*.cu``, all at once).
2. Kernels vs plain versions on edge cases: K1 (gather + dequant) bit-exact on
   int8 / fp8 / bf16 / f32 / int4 tables with device, per-key and no scales,
   N = 0 and the miss row; K2 / K3 (dot interaction) on general and
   part-major feature maps with phantom rows and on int8 / fp8 / bf16 / f32
   arenas, within rtol 1e-5 and atol 1e-6 * max|z|^2: both sides see the same
   bf16 z and differ only in the order of the f32 sums.
3. The main path at full width: a Criteo-Kaggle-shaped DLRM (the 26
   categorical cardinalities, each capped at 262,144 rows; D = 128, int8;
   13 dense features; bottom MLP 512-256-128, top MLP 1024-1024-512-256-1;
   random weights from a numpy seed) through ``HierParameterServer`` ->
   ``LookupSession.lookup`` (bit-exact against a host dequant) ->
   ``make_dlrm_multi_server(...).predict`` on batches of 4096, with the
   one-hot group folded into the interaction (K1 + K3) and with
   ``HPS_OH_IN_KERNEL=0`` (K1 + K2). The launch counts of the run must show
   every kernel.
4. Each kernel timed at the shapes the main path gave it, beside its plain
   version, one PyTorch call for the same product where there is one, and
   its bound (the larger of bytes over the memory rate and operations over
   the bf16 tensor-core rate of the card).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The 26 Criteo-Kaggle categorical cardinalities (C1..C26).
CRITEO_CARDS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
]
ROW_CAP = 262_144
DIM = 128
NUM_DENSE = 13
BATCH = 4096
N_BATCHES = 3
BOTTOM = (512, 256, DIM)
TOP = (1024, 1024, 512, 256, 1)
SEED = 2026

RTOL = 1e-5  # K2/K3 vs plain: f32 summation order only
REL_LOGITS = 5e-3  # fold vs no fold, the JAX package's bar (test_fused_models.py)

# Dense peaks (NVIDIA data sheets): memory bytes/s, bf16 tensor FLOP/s.
PEAKS = (
    ("H200", 4.8e12, 989e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100", 3.35e12, 989e12),  # SXM
)

SOURCES = {
    "gather_dequant": ("hugectr_backend_tpu_torch/csrc/gather_dequant.cu",
                       "hugectr_backend_tpu/ops/dequant_gather.py:54"),
    "dot_interaction_parts": ("hugectr_backend_tpu_torch/csrc/dot_interaction.cu",
                              "hugectr_backend_tpu/ops/fused_interaction.py:298"),
    "dot_interaction_oh_parts": ("hugectr_backend_tpu_torch/csrc/dot_interaction.cu",
                                 "hugectr_backend_tpu/ops/fused_interaction.py:620"),
}


def peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no peak rates known for {name!r}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ checks


def zmax(feats) -> float:
    return max(float(f.to(torch.bfloat16).float().abs().max()) for f in feats if f.numel())


def interaction_err(got, want, zm):
    """-> (ok, max_abs_err) under rtol RTOL and atol 1e-6 * max|z|^2."""
    err = (got - want).abs()
    ok = bool((err <= 1e-6 * zm * zm + RTOL * want.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def k1_edge_checks(dev) -> int:
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_ref
    from hugectr_backend_tpu_torch.tiers.hbm import quantize_host_rows

    rng = np.random.default_rng(1)
    n_checks = 0
    for quant in ("int8", "fp8", "bf16", "fp32", "int4"):
        for dim in (DIM, 36):  # 16-byte vector path and the scalar path
            vecs = rng.standard_normal((1000, dim)).astype(np.float32)
            vals, scales = quantize_host_rows(vecs, quant, 0.25)
            values = vals.to(dev)
            dsc = None if scales is None else torch.from_numpy(scales).to(dev)
            rows = values.shape[0]
            for n in (0, 1, 777):
                sl = rng.integers(0, rows, n).astype(np.int32)
                if n:
                    sl[-1] = rows - 1  # the miss (default) row
                slots = torch.from_numpy(sl).to(dev)
                per_key = torch.from_numpy(
                    (rng.random(n) + 0.5).astype(np.float32)).to(dev)
                modes = [(None, None), (None, per_key)]
                if dsc is not None:
                    modes.append((dsc, None))
                for ds, si in modes:
                    got = gather_dequant(values, ds, slots, si)
                    want = gather_dequant_ref(values, ds, slots, si)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    if got.shape != (n, dim) or not torch.equal(got, want):
                        raise AssertionError(
                            f"K1 {quant} dim {dim} n {n} scales "
                            f"{'device' if ds is not None else 'per-key' if si is not None else 'none'}"
                            ": kernel != plain")
                    n_checks += 1
    return n_checks


def k2_k3_edge_checks(dev) -> int:
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        oh_rows_ref,
        part_major_order,
    )

    g = torch.Generator().manual_seed(3)
    n_checks = 0
    for b, d in ((4096, DIM), (13, DIM), (40, 30)):
        bottom = torch.randn(b, d, generator=g).to(dev)
        # Parts with phantom tail rows (S > B) and unmapped subs.
        parts = [torch.randn(n, s, d, generator=g).to(dev)
                 for n, s in ((5, b + 3), (3, b), (1, b + 8))]
        general = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))
        _, part_major = part_major_order(general)
        # Strided views of a stacked [B, T, D] tensor; T = 40 takes the
        # interaction past one 32-row tile.
        cases = [(parts, general), (parts, part_major)]
        for t in (4, 40):
            stacked = torch.randn(b, t, d, generator=g).to(dev).transpose(0, 1)
            cases.append(([stacked], tuple((0, i) for i in range(t))))
        for ps, fmap in cases:
            got = dot_interaction_parts(bottom, ps, fmap)
            want = dot_interaction_parts_ref(bottom, ps, fmap)
            zm = zmax([bottom] + [ps[p][s][:b] for p, s in fmap])
            ok, err = interaction_err(got, want, zm)
            if not ok:
                raise AssertionError(f"K2 B={b} D={d} map {fmap}: max err {err}")
            n_checks += 1
        for dt in (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32):
            arena = (torch.randn(300, d, generator=g) * 60).clamp(-127, 127)
            arena = arena.round().to(dt) if dt == torch.int8 else arena.to(dt)
            arena = arena.to(dev)
            slots = torch.randint(0, 300, (3, b + 5), generator=g, dtype=torch.int32).to(dev)
            scales = (torch.rand(3, b + 5, generator=g) + 0.01).to(dev)
            for sc in (scales, None):
                got = dot_interaction_oh_parts(bottom, arena, slots, sc, parts, part_major)
                want = dot_interaction_oh_parts_ref(bottom, arena, slots, sc, parts, part_major)
                zm = zmax([bottom] + oh_rows_ref(arena, slots, sc, b)
                          + [parts[p][s][:b] for p, s in part_major])
                ok, err = interaction_err(got, want, zm)
                if not ok:
                    raise AssertionError(f"K3 {dt} B={b} D={d}: max err {err}")
                n_checks += 1
    return n_checks


# --------------------------------------------------------------- main path


def build_deployment(root: str, cards, dim: int, seed: int):
    """Write the sparse tables, create the parameter server on the card."""
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table

    tables = []
    for t, n in enumerate(cards):
        tbl = make_synthetic_table(n, dim, seed=seed + t)
        write_sparse_model(os.path.join(root, f"t{t}"), tbl.keys, tbl.vectors)
        tables.append(tbl)
    cfg = {"models": [{
        "model": "dlrm",
        "sparse_files": [os.path.join(root, f"t{t}") for t in range(len(cards))],
        "embedding_vecsize_per_table": [dim] * len(cards),
        "maxnum_catfeature_query_per_table_per_sample": [1] * len(cards),
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 8,
        "deployed_device_list": [0],
    }]}
    return tables, cfg


def make_model(num_tables: int, seed: int):
    """DLRM with weights drawn from a numpy seed (lecun-normal, zero bias)."""
    from hugectr_backend_tpu_torch.models.dlrm import DLRM

    model = DLRM(NUM_DENSE, num_tables, BOTTOM, TOP)
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight"):
            w = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])
        else:
            w = np.zeros(tuple(p.shape))
        state[name] = torch.from_numpy(w.astype(np.float32))
    model.load_state_dict(state)
    return model


def make_batches(tables, batch: int, n: int, seed: int):
    """n batches of (keys per table [B, 1] with ~1% misses, dense [B, 13])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = []
        for tbl in tables:
            k = tbl.keys[rng.integers(0, tbl.num_rows, batch)].copy()
            miss = rng.random(batch) < 0.01
            k[miss] = -1 - rng.integers(0, 1 << 40, int(miss.sum()))
            keys.append(k.reshape(batch, 1))
        out.append((keys, rng.standard_normal((batch, NUM_DENSE)).astype(np.float32)))
    return out


def host_dequant(cache, keys):
    """Per-table f32 rows from the cache's stored bytes, in numpy."""
    outs = []
    for t, k in enumerate(keys):
        view = cache.tables[t]
        vals = view.arena.values.cpu().numpy()
        scales = view.arena.scales.cpu().numpy()
        gs = view.offset + view.index.lookup(np.asarray(k).reshape(-1)).astype(np.int64)
        outs.append(vals[gs].astype(np.float32) * scales[gs][:, None])
    return outs


class Recorder:
    """Record the inputs the main path gives each kernel wrapper (one
    predict, outside the counted run)."""

    def __init__(self):
        import hugectr_backend_tpu_torch.cache.lookup_program as lp
        import hugectr_backend_tpu_torch.models.dlrm as dl

        self.calls = {"gather_dequant": [], "dot_interaction_parts": [],
                      "dot_interaction_oh_parts": []}
        self._patches = [(lp, "gather_dequant"), (dl, "dot_interaction_parts"),
                         (dl, "dot_interaction_oh_parts")]
        self._orig = {}

    def __enter__(self):
        for mod, name in self._patches:
            orig = getattr(mod, name)
            self._orig[(mod, name)] = orig

            def rec(*args, _o=orig, _n=name):
                self.calls[_n].append(args)
                return _o(*args)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self._orig.items():
            setattr(mod, name, orig)


def predict_sync(srv, keys, dense):
    out = srv.predict(keys, dense)
    torch.cuda.synchronize()
    return out


# ------------------------------------------------------------------ timing


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA-event time per call of back-to-back eager calls: the larger of
    the device time and the host's launch overhead (Python wrapper
    included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed, timed with CUDA events. No host launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    return ms


def timings(kernel, plain, library) -> dict:
    return {
        "kernel_ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(library),
        "eager_ms": eager_ms(kernel),
    }


def predict_profile(srv, batches):
    """Device kernel time per predict (torch.profiler, CUPTI) and the
    kernels that take it. -> (busy_ms or None, [(name, ms per predict)])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for bt in batches:
            predict_sync(srv, *bt)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None, []
    n = len(batches)
    top = sorted(((k[:80], v / n) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return sum(by_name.values()) / n, top[:8]


def k1_measure(args, bw):
    from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_ref

    values, ds, slots, si = args
    got = gather_dequant(values, ds, slots, si)
    want = gather_dequant_ref(values, ds, slots, si)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 at a main-path shape: kernel != plain")
    n, d = got.shape
    uniq = torch.unique(slots).numel()
    row_bytes = values.shape[1] * values.element_size()
    nbytes = (uniq * row_bytes + n * 4 + n * d * 4
              + (uniq * 4 if ds is not None else 0) + (n * 4 if si is not None else 0))
    idx = slots.long()
    return {
        "shape": {"table_rows": values.shape[0], "n": n, "d": d,
                  "dtype": str(values.dtype).replace("torch.", ""),
                  "scales": "device" if ds is not None else "per-key" if si is not None else "none"},
        "max_abs_err": float((got - want).abs().max()) if n else 0.0,
        **timings(lambda: gather_dequant(values, ds, slots, si),
                  lambda: gather_dequant_ref(values, ds, slots, si),
                  lambda: torch.index_select(values, 0, idx)),
        "bound_ms": nbytes / bw * 1e3,
        "bound_by": "bytes",
    }


def interaction_measure(name, fn, ref, args, feats, in_bytes, bw, flops):
    """``in_bytes``: what the kernel must read (each input once)."""
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    ok, err = interaction_err(got, want, zmax(feats))
    if not ok:
        raise AssertionError(f"{name} at the main-path shape: max err {err}")
    del got, want
    f = len(feats)
    b, d = feats[0].shape
    pairs = f * (f - 1) // 2
    z = torch.stack(feats, dim=1).to(torch.bfloat16)
    zt = z.transpose(1, 2)
    t_bytes = (in_bytes + b * (d + pairs) * 4) / bw * 1e3
    t_ops = 2.0 * b * pairs * d / flops * 1e3
    return {
        "shape": {"batch": b, "features": f, "d": d},
        "max_abs_err": err,
        **timings(lambda: fn(*args), lambda: ref(*args), lambda: torch.bmm(z, zt)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


# -------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.ops.fused_interaction import (
        dot_interaction_oh_parts,
        dot_interaction_oh_parts_ref,
        dot_interaction_parts,
        dot_interaction_parts_ref,
        oh_rows_ref,
    )
    from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card} | nvidia-smi: {smi}", flush=True)
    bw, flops = peaks(card)

    # Phase 1: build.
    t0 = time.perf_counter()
    took = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()), flush=True)
    for name in kernels.SOURCES:
        log = kernels._target(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    # Phase 2: kernels vs plain on edge cases.
    t0 = time.perf_counter()
    n1 = k1_edge_checks(dev)
    n23 = k2_k3_edge_checks(dev)
    torch.cuda.synchronize()
    print(f"edge checks: K1 {n1} bit-exact, K2/K3 {n23} within rtol {RTOL}, "
          f"atol 1e-6*max|z|^2 ({time.perf_counter() - t0:.1f} s)", flush=True)

    # Phase 3: the main path at full width.
    cards = [min(c, ROW_CAP) for c in CRITEO_CARDS]
    with tempfile.TemporaryDirectory(prefix="hps_chip_smoke_") as root:
        t0 = time.perf_counter()
        tables, cfg = build_deployment(root, cards, DIM, SEED)
        ps = HierParameterServer.create(cfg)
        print(f"deploy: {sum(cards)} rows in {len(cards)} tables, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    cache = ps.get_embedding_cache("dlrm", 0)
    kinds = [g[1] for g in cache._groups]
    print(f"lookup groups: {kinds} ({cache.nbytes() / 1e9:.3f} GB on the card)", flush=True)
    session = LookupSession.create(ps.get_model_params("dlrm"), cache)
    model = make_model(len(cards), SEED)
    srv = make_dlrm_multi_server(ps.get_model_params("dlrm"), cache, model)
    batches = make_batches(tables, BATCH, N_BATCHES, SEED + 1)
    lookup_keys = [k.reshape(-1) for k in batches[0][0]]

    # Record each kernel's main-path inputs (one predict per mode, uncounted).
    with Recorder() as rec_fold:
        predict_sync(srv, *batches[0])
    os.environ["HPS_OH_IN_KERNEL"] = "0"
    with Recorder() as rec_plain:
        predict_sync(srv, *batches[0])
    del os.environ["HPS_OH_IN_KERNEL"]

    kernels.launches.clear()
    rows = session.lookup(lookup_keys)
    torch.cuda.synchronize()
    after_lookup = dict(kernels.launches)
    logits_fold = [predict_sync(srv, *bt) for bt in batches]
    after_fold = dict(kernels.launches)
    os.environ["HPS_OH_IN_KERNEL"] = "0"
    logits_k2 = [predict_sync(srv, *bt) for bt in batches]
    del os.environ["HPS_OH_IN_KERNEL"]
    launches = dict(kernels.launches)
    print(f"main path launches: {launches}; lookup {after_lookup}; "
          f"per fold predict { {k: (after_fold.get(k, 0) - after_lookup.get(k, 0)) / N_BATCHES for k in SOURCES} }; "
          f"per K2 predict { {k: (launches.get(k, 0) - after_fold.get(k, 0)) / N_BATCHES for k in SOURCES} }",
          flush=True)
    for name in SOURCES:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the main path never launched {name}")

    want_rows = host_dequant(cache, lookup_keys)
    for t, (got, want) in enumerate(zip(rows, want_rows)):
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"lookup table {t}: not bit-exact vs host dequant")
    print(f"lookup: {len(rows)} tables x {BATCH} keys bit-exact vs host dequant",
          flush=True)
    worst = 0.0
    for a, c in zip(logits_fold, logits_k2):
        if a.shape != (BATCH,) or not bool(torch.isfinite(a).all()):
            raise AssertionError("fold logits are not finite [B]")
        rel = float((a - c).abs().max() / (c.abs().max() + 1e-9))
        worst = max(worst, rel)
    if worst >= REL_LOGITS:
        raise AssertionError(f"fold vs K2 logits rel {worst} >= {REL_LOGITS}")
    # Against a CPU reference on the first 64 samples: plain versions on
    # the host-dequantized embeddings.
    keys0, dense0 = batches[0]
    emb = np.stack([r[:64] for r in host_dequant(cache, keys0)], axis=1)
    ref = make_model(len(cards), SEED)(torch.from_numpy(dense0[:64]),
                                       torch.from_numpy(emb)).detach()
    rel_ref = float((logits_fold[0][:64].cpu() - ref).abs().max() / (ref.abs().max() + 1e-9))
    if rel_ref >= 1e-3:
        raise AssertionError(f"logits vs CPU reference rel {rel_ref}")
    print(f"predict: {N_BATCHES} x {BATCH} finite; fold vs K2 rel {worst:.3g}; "
          f"vs CPU reference rel {rel_ref:.3g}", flush=True)

    # Per-predict wall time (host clock around predict + synchronize), the
    # host's share (key translation + argument assembly, which predict runs
    # under the cache lock) and the device's kernel time (profiler).
    for mode in ("fold", "k2"):
        if mode == "k2":
            os.environ["HPS_OH_IN_KERNEL"] = "0"
        ts, hs = [], []
        for i in range(12):
            keys, dense = batches[i % N_BATCHES]
            t0 = time.perf_counter()
            predict_sync(srv, keys, dense)
            ts.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            with cache._lock:
                local = [cache.translate(t, k.reshape(-1)) for t, k in enumerate(keys)]
                cache.prepare_lookup([BATCH] * len(keys), local)
            hs.append((time.perf_counter() - t0) * 1e3)
        busy, top = predict_profile(srv, batches)
        os.environ.pop("HPS_OH_IN_KERNEL", None)
        ts, hs = sorted(ts[2:]), sorted(hs[2:])
        med = ts[len(ts) // 2]
        emit({"predict_ms": {"mode": mode, "batch": BATCH, "median": med,
                             "min": ts[0], "max": ts[-1], "runs": len(ts),
                             "host_translate_prepare_median": hs[len(hs) // 2],
                             "device_kernel_ms": busy,
                             "device_idle_share": None if busy is None else 1 - busy / med,
                             "top_device_kernels_ms": top},
              "card": card, "nvidia_smi": smi})

    # Phase 4: each kernel at its main-path shapes.
    results = {}
    # K1: the fold predict's arena and solo groups, and the no-fold
    # predict's one-hot group (the largest call).
    onehot = max(rec_plain.calls["gather_dequant"], key=lambda a: a[2].shape[0])
    for args in rec_fold.calls["gather_dequant"] + [onehot]:
        r = k1_measure(args, bw)
        emit({"kernel": "gather_dequant", **r, "card": card, "nvidia_smi": smi})
        if r["shape"]["scales"] == "device":
            results["gather_dequant"] = r
    b, d = BATCH, DIM
    (bottom, parts, fmap), = rec_plain.calls["dot_interaction_parts"]
    feats = [bottom] + [parts[p][s][:b] for p, s in fmap]
    r = interaction_measure("dot_interaction_parts", dot_interaction_parts,
                            dot_interaction_parts_ref, (bottom, parts, fmap),
                            feats, len(feats) * b * d * 4, bw, flops)
    results["dot_interaction_parts"] = r
    emit({"kernel": "dot_interaction_parts", **r, "card": card, "nvidia_smi": smi})
    (bottom, arena, slots, scales, parts, fmap), = rec_fold.calls["dot_interaction_oh_parts"]
    n_oh = slots.shape[0]
    fed = [bottom] + [parts[p][s][:b] for p, s in fmap]
    feats = [bottom] + oh_rows_ref(arena, slots, scales, b) + fed[1:]
    # The one-hot rows are read from the arena (its distinct rows), with a
    # slot and a scale per (feature, sample).
    in_bytes = (len(fed) * b * d * 4
                + torch.unique(slots[:, :b]).numel() * d * arena.element_size()
                + n_oh * b * (4 + (4 if scales is not None else 0)))
    r = interaction_measure("dot_interaction_oh_parts", dot_interaction_oh_parts,
                            dot_interaction_oh_parts_ref,
                            (bottom, arena, slots, scales, parts, fmap),
                            feats, in_bytes, bw, flops)
    results["dot_interaction_oh_parts"] = r
    emit({"kernel": "dot_interaction_oh_parts", **r, "card": card, "nvidia_smi": smi})

    print(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["kernel_ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         "library_ms": results[name]["library_ms"]}
        for name, (src, rep) in SOURCES.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
