"""The ``dlrm_ensemble`` kind (MLPerf DLRM behind the program's KServe
ensemble) on the CPU: a shrunk copy of ``dlrm1tb-ens-d128`` through
``run.run_cell`` is judged correct, and not correct with the bf16 control,
another seed's weights or a fault in the fused path's lookup; the plain
reference by hand; the bytes and FLOPs of ``ens_k1_roofline``,
``interaction_roofline`` and ``mfu`` on a two-request slice worked out by
hand."""

import copy
import dataclasses
import importlib
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from hpsbench import run, spec
from hpsbench.deploy import dlrm_ensemble as kind
from hpsbench.metrics import ens_k1_roofline, interaction_roofline, mfu
from hpsbench.reference.dlrm_ensemble import DlrmReference
from hpsbench.reference.hps import dequantized
from hpsbench.traffic import Request

CELL = "dlrm1tb-ens.q100-700-c8"
SEED = 2**31 + 2501
#: Rows a table in the shrunk copy: 15 of the 26 tables stay past the
#: one-hot group's 4,095 rows, as at the configuration's size.
ROW_CAP = 20_000


def load_cell() -> spec.Cell:
    return spec.load(CELL)


def shrunk(loop="closed"):
    cell = load_cell()
    cell.cfg["rows_per_table"] = [min(r, ROW_CAP) for r in cell.cfg["rows_per_table"]]
    cell.mix.update(warm_s=0.5, pool=6, clients=3)
    if loop == "open":
        cell.mix.update(loop="open", rate_rps=4.0, connections=4)
    return cell


def run_judged(monkeypatch, cell, trace=False, seconds=1.5):
    """One CPU run of ``cell``; -> (result, the judge's context)."""
    seen = []
    real = kind.judge

    def judge(ctx, control=None):
        seen.append(ctx)
        return real(ctx, control)

    monkeypatch.setattr(kind, "judge", judge)
    run.set_cache_dirs()
    return run.run_cell(cell, SEED, seconds, trace, "cpu", run.process_start()), seen[0]


def test_shrunk_cell_is_correct_and_fully_fused(monkeypatch):
    out, ctx = run_judged(monkeypatch, shrunk(), trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = out["checks"]
    assert checks["wrong_answers"]["value"] == 0 and checks["unjudged_answers"]["value"] == 0
    assert 0 < checks["max_abs_gap"]["value"] <= checks["max_abs_gap"]["limit"]
    metrics = out["metrics"]
    assert metrics["fused_share.ens"]["value"] == 100.0
    for name in ("ens_fused_ms", "ens_translate_ms", "ens_assemble_ms", "ens_launch_ms",
                 "ens_copy_back_ms"):
        assert metrics[f"{name}.ens"]["value"] > 0, name
    assert metrics["ens_fused_ms.ens"]["value"] > metrics["ens_launch_ms.ens"]["value"]
    for name in ("p50_ms.ens", "p95_ms.ens", "samples_per_s.ens", "frontend_ms.ens"):
        assert name in metrics, name
    # No device trace and no card's peaks on the CPU: the shares find nothing.
    for name in ("ens_k1_roofline.ens", "interaction_roofline.ens", "mfu.ens"):
        assert name not in metrics
    sizes = {r.samples for r in ctx.requests}
    assert sizes <= set(range(100, 701, 25))
    for r in ctx.requests:
        assert r.dense.shape == (r.samples, 13) and len(r.keys) == 26


def test_control_and_another_seeds_weights_are_not_correct(monkeypatch):
    out, ctx = run_judged(monkeypatch, shrunk("open"), seconds=1.0)
    assert out["correct"], out["checks"]
    control = run.judge(ctx, kind.CONTROL)
    assert not run.passes(control)
    # On the card the control reads 2.8x, 2.1x and 190x the limits at least.
    lim = ctx.limits
    assert control["max_abs_gap"][0] > 2 * lim["max_abs_gap"]
    assert control["max_rel_gap"][0] > 2 * lim["max_rel_gap"]
    assert control["median_abs_gap"][0] > 10 * lim["median_abs_gap"]
    other = run.judge(dataclasses.replace(ctx, seed=ctx.seed + 1))
    assert not run.passes(other) and other["wrong_answers"][0] > 0


@pytest.mark.parametrize("fault", ("alter", "half"))
def test_a_fault_in_the_fused_lookup_is_not_correct(monkeypatch, fault):
    """K1's largest group output broken under the fused path: one value
    altered, or the second half of it left out."""
    from hugectr_backend_tpu_torch.cache import lookup_program

    real = lookup_program.lookup_groups

    def broken(*args):
        outs = list(real(*args))
        big = max((g for g, o in enumerate(outs) if o is not None),
                  key=lambda g: outs[g].numel())
        out = outs[big] = outs[big].clone()
        if fault == "alter":
            out.view(-1)[out.numel() // 3] += 0.5
        else:
            out.view(-1)[out.numel() // 2:] = 0.0
        return outs

    monkeypatch.setattr(lookup_program, "lookup_groups", broken)
    out, _ = run_judged(monkeypatch, shrunk(), seconds=1.0)
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


def test_cell_entries_keep_to_the_contract():
    """BENCHMARK.json's entries for the cell: one configuration, one 1-chip
    cell, per-layer metrics that each have a reader and list only it."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names)), key
    cells = [w for w in bench["workloads"] if w["config"] == "dlrm1tb-ens-d128"]
    assert [w["name"] for w in cells] == [CELL] and cells[0]["chips"] == 1
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", ())]
    for m in mine:
        assert m["workloads"] == [CELL] and m["moves"] == "memory_resident_mb"
        assert callable(importlib.import_module(
            f"hpsbench.metrics.{m['name'].split('.')[0]}").read)
    cell = load_cell()
    assert {m["name"] for m in cell.end_to_end} == {"memory_resident_mb", "setup_s"}
    assert len(cell.per_layer) == len(mine) == 15


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t``'s f32 values rounded to TF32's 10 mantissa bits, to nearest
    even: the operands the card's tensor cores take with TF32 on."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def test_tf32_in_the_mlps_is_not_correct(monkeypatch):
    """TF32 operands in every MLP layer (the configuration states TF32
    off): the largest gaps stay inside their limits, as on the card, and
    the median gap is past its own."""
    import torch.nn.functional as F

    import hugectr_backend_tpu_torch.models.dlrm as dlrm

    def dense_tf32(x, layer, mixed_precision=False, weight=None,
                   compute_dtype=torch.float32):
        w = layer.weight if weight is None else weight
        return F.linear(tf32(x), tf32(w), layer.bias)

    monkeypatch.setattr(dlrm, "dense", dense_tf32)
    out, _ = run_judged(monkeypatch, shrunk(), seconds=1.0)
    median = out["checks"]["median_abs_gap"]
    assert not out["correct"] and median["value"] > 10 * median["limit"], out["checks"]


def test_warm_sizes_cover_every_bucket():
    cell = load_cell()
    assert kind.warm_sizes(cell.cfg, cell.mix) == [128, 256, 512, 1024]
    assert kind.warm_sizes(cell.cfg, {"samples_per_request": 5}) == [8]


def test_weights_are_flax_init_from_the_seed():
    cfg = load_cell().cfg
    bottom, top = kind.weights(cfg, 7)
    assert [w.shape for w, _ in bottom] == [(13, 512), (512, 256), (256, 128)]
    assert [w.shape for w, _ in top] == [(479, 1024), (1024, 1024), (1024, 512), (512, 256),
                                        (256, 1)]
    for w, b in bottom + top:
        std = (1.0 / w.shape[0]) ** 0.5 / kind.TRUNC_STD
        assert np.abs(w).max() <= 2 * std and not b.any()
    w = top[1][0]
    assert abs(w.var() * w.shape[0] - 1.0) < 0.01
    again, _ = kind.weights(cfg, 7)
    other, _ = kind.weights(cfg, 8)
    assert np.array_equal(again[0][0], bottom[0][0])
    assert not np.array_equal(other[0][0], bottom[0][0])


def test_reference_by_hand():
    """Two tables at D 2, bottom 1 -> 2, top 4 -> 1: the interaction's z in
    bf16, its pairs row by row, ReLU after the bottom, none after the top."""
    t0 = np.array([[1.0, 0.5], [0.25, -1.0]], np.float32)
    t1 = np.array([[2.0, 1.0]], np.float32)
    bottom = [(np.array([[1.0, 1.0 + 2**-12]], np.float32), np.zeros(2, np.float32))]
    top = [(np.array([[1.0], [2.0], [3.0], [4.0], [5.0]], np.float32), np.array([0.5], np.float32))]
    ref = DlrmReference([t0, t1], bottom, top)
    dense = np.array([[3.0], [2.0]], np.float32)
    got = ref.logits(dense, [np.array([1, 0]), np.array([-1, 0])])
    d0, d1 = dequantized(t0), dequantized(t1)
    want = []
    for x0, e0, e1 in [(3.0, d0[1], np.zeros(2)), (2.0, d0[0], d1[0])]:
        x = np.array([x0, np.float32(x0 * (1.0 + 2**-12))], np.float64)
        zb = [torch.tensor(v, dtype=torch.float32).bfloat16().double().numpy()
              for v in (x, e0, e1)]
        pairs = [zb[0] @ zb[1], zb[0] @ zb[2], zb[1] @ zb[2]]
        want.append(np.concatenate([x, pairs]) @ top[0][0][:, 0] + 0.5)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # 3 * (1 + 2**-12) is no bf16: z rounds it, the bottom output keeps it.
    ctl = ref.control().logits(dense, [np.array([1, 0]), np.array([-1, 0])])
    assert not np.array_equal(ctl, got)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; import hpsbench.reference.dlrm_ensemble, "
            "hpsbench.deploy.dlrm_ensemble; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(spec.ROOT), check=True,
                         capture_output=True, text=True).stdout
    mods = set(json.loads(out.splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "hugectr_backend_tpu",
                       "hugectr_backend_tpu_torch"}


# -------------------------------------------------------- counts by hand

HAND_CFG = {"kind": "dlrm_ensemble", "model": "hand_counted_ens", "embedding_dim": 4,
            "rows_per_table": [10, 2, 9], "num_dense": 2, "bottom_mlp": [3, 4],
            "top_mlp": [5, 1]}
PEAKS = {"hbm_bytes_per_s": 1e3, "f32_flops_per_s": 1e3}


def op(name, seconds):
    return types.SimpleNamespace(name=name, start_us=0.0, end_us=seconds * 1e6)


@pytest.fixture
def hand_ctx():
    """Tables 0 and 2 gathered by K1, table 1 folded (as the program's gauge
    reports them); requests A (2 samples) and B (3) answered in the slice
    [1, 2], a third after it."""
    from hugectr_backend_tpu_torch.serving import metrics

    for t, folded in enumerate((0.0, 1.0, 0.0)):
        metrics.ENSEMBLE_FUSED_FOLDED.set(folded, model=HAND_CFG["model"], table=str(t))
    a = Request(2, [np.array([5, 5]), np.array([1, -1]), np.array([0, 3])], [None] * 3)
    b = Request(3, [np.array([-1, 2, 2]), np.array([0, 0, 0]), np.array([7, 7, 7])],
                [None] * 3)
    late = Request(4, [np.zeros(4, int)] * 3, [None] * 3)
    res = types.SimpleNamespace(entry=np.array([0, 1, 2]), ok=np.ones(3, bool),
                                done=np.array([1.2, 1.9, 2.5]))
    ops = [op("void grouped_gather_kernel<8>(Params<8>)", 0.5),
           op("void dot_interaction_kernel<signed char, true, 128, float>(Params<128>)", 1.5),
           op("void dot_interaction_wide_kernel<signed char, float>(WideParams)", 0.5),
           op("void dot_interaction_bwd_kernel<true>(BwdParams)", 9.0),
           op("Memcpy DtoH (Device -> Pageable)", 3.0)]
    ctx = types.SimpleNamespace(
        cfg=HAND_CFG, peaks=PEAKS, requests=[a, b, late], results=res,
        trace=types.SimpleNamespace(ops=ops, t0=1.0, t1=2.0, wall_s=1.0))
    ctx.answered_in = lambda t0, t1: np.flatnonzero(res.ok & (res.done >= t0) & (res.done <= t1))
    return ctx


def test_k1_bytes_by_hand(hand_ctx):
    # A: table 0 one distinct row (8 B) + 2 keys x 16 B; table 2 two rows + 32 B
    # B: table 0 row 2 and the default row + 48 B; table 2 one row + 48 B
    a, b = hand_ctx.requests[:2]
    assert ens_k1_roofline.request_bytes(a, 4, [0, 2]) == 40 + 48
    assert ens_k1_roofline.request_bytes(b, 4, [0, 2]) == 64 + 56
    assert ens_k1_roofline.read(hand_ctx) == pytest.approx(100 * 0.208 / 0.5)


def test_interaction_bytes_by_hand(hand_ctx):
    # F = 4, 6 pairs, 10 outputs of 4 B a sample; each sample reads the bottom
    # and the two gathered vectors (3 x 16 B); table 1's distinct rows once.
    a, b = hand_ctx.requests[:2]
    assert interaction_roofline.request_bytes(a, 4, [0, 2], [1]) == 96 + 2 * 8 + 80
    assert interaction_roofline.request_bytes(b, 4, [0, 2], [1]) == 144 + 8 + 120
    # the bwd kernel and the copy are not the interaction's forward
    assert interaction_roofline.read(hand_ctx) == pytest.approx(100 * 0.464 / 2.0)


def test_mfu_flops_by_hand(hand_ctx):
    # bottom 2-3-4: 18 MACs; top 10-5-1: 55; 6 pairs of 4: 24 -> 2 * 97 = 194
    assert mfu.flops_per_sample(HAND_CFG) == 194
    assert mfu.read(hand_ctx) == pytest.approx(100 * 5 * 194 / 1e3)
    assert mfu.flops_per_sample(load_cell().cfg) == 4_820_224


def test_readers_find_nothing_without_the_gauge(hand_ctx):
    cfg = copy.deepcopy(HAND_CFG)
    cfg["model"] = "an_ensemble_never_served"
    ctx = types.SimpleNamespace(**{**vars(hand_ctx), "cfg": cfg})
    assert ens_k1_roofline.read(ctx) is None and interaction_roofline.read(ctx) is None
    ctx.trace = None
    assert mfu.read(ctx) is None
