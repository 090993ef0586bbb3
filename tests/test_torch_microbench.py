"""The port's lookup microbenchmarks build what the JAX package's scripts
build: the tile layout, the plans, the tables of ``gen_flat`` and the Zipf
slots; and their correctness steps pass on the CPU.

The JAX scripts are imported by path (their ``main`` is guarded) and run at
batch 64. The int8 values of ``gen_flat`` are equal; its f32 scales are the
formula's (one multiply, one add, as the script's program states) bit for
bit, and within one ulp of JAX's on the CPU, whose compiler contracts the
multiply and the add into one fused operation in its vectorized loops.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
from hugectr_backend_tpu_torch.scripts import common
from hugectr_backend_tpu_torch.scripts import microbench_onehot as mo
from hugectr_backend_tpu_torch.scripts import microbench_true as mt

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _load(name) for name in ("microbench_onehot", "microbench_onehot_v2",
                                           "microbench_true")}


def _formula_scales(rows):
    r = np.arange(rows)
    return np.float32(0.01) + (r % 50).astype(np.float32) * np.float32(0.001)


def _check_flat(values, scales, jv, js):
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(scales.numpy(), _formula_scales(values.shape[0]))
    ulps = np.abs(scales.numpy().view(np.int32) - np.asarray(js).view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("m_tile", [32, 64])
def test_layout_and_plan_match_jax_microbench_onehot(jax_scripts, monkeypatch, m_tile):
    jmo = jax_scripts["microbench_onehot"]
    monkeypatch.setattr(jmo, "BATCH", BATCH)
    tiles, r_total, plan = jmo.build(m_tile, common.R_TILE)
    assert jmo.CARDS == common.TINY_CARDS
    assert common.tile_layout(common.TINY_CARDS, common.R_TILE) == (tiles, r_total)
    arena = common.build_arena(common.TINY_CARDS, common.R_TILE, "cpu")
    got = arena.plan(BATCH, m_tile)
    for name in ("kt", "rt", "first"):
        np.testing.assert_array_equal(getattr(got, name), getattr(plan, name))
    assert (got.num_key_tiles, got.m_tile, got.r_tile) == (
        plan.num_key_tiles, plan.m_tile, plan.r_tile)


def test_jax_microbench_onehot_plan_ignores_its_r_tile(jax_scripts, monkeypatch):
    """The JAX script's ``build`` lays members out in r_tile units but plans
    with the default r_tile of 512, so its r_tile 1024 and 2048 configs read
    the wrong rows; the port plans with the arena's r_tile and sweeps
    m_tile at r_tile 512 only."""
    jmo = jax_scripts["microbench_onehot"]
    monkeypatch.setattr(jmo, "BATCH", BATCH)
    assert jmo.build(64, 1024)[2].r_tile == 512
    assert common.build_arena([5, 600], 1024, "cpu").plan(BATCH, 64).r_tile == 1024


@pytest.mark.parametrize("tag", ["tiny16", "mid18"])
def test_setup_matches_jax_microbench_onehot_v2(jax_scripts, monkeypatch, tag):
    jv2 = jax_scripts["microbench_onehot_v2"]
    monkeypatch.setattr(jv2, "BATCH", BATCH)
    cards = {"tiny16": jv2.TINY_CARDS, "mid18": jv2.MID_CARDS}[tag]
    assert cards == mo.CARD_SETS[tag]
    tiles, r_total, plan, v, sc, _, _, slots_fn = jv2.setup(cards, common.R_TILE, BATCH)
    arena = common.build_arena(cards, common.R_TILE, "cpu")
    assert (arena.tiles, arena.values.shape[0]) == (tiles, r_total)
    got = arena.plan(BATCH, BATCH)
    for name in ("kt", "rt", "first"):
        np.testing.assert_array_equal(getattr(got, name), getattr(plan, name))
    _check_flat(arena.values, arena.scales, v, sc)
    for seed in (1, 2):
        np.testing.assert_array_equal(arena.slots(seed, BATCH)[0], np.asarray(slots_fn(seed)))


@pytest.mark.parametrize("rows", [3, 2000, 47_398])
def test_gen_flat_matches_jax_microbench_true(jax_scripts, rows):
    jv, js = jax_scripts["microbench_true"].gen_flat(rows)
    values, scales = common.gen_flat(rows, "cpu")
    assert values.shape == (rows, common.DIM) and values.dtype == torch.int8
    _check_flat(values, scales, jv, js)


def test_slots_follow_jax_microbench_true(jax_scripts):
    """The arena, big-table and tiny-table slots of microbench_true.py:86-90,
    :123-125 and :245-249."""
    jt = jax_scripts["microbench_true"]
    assert (jt.BIG_CARDS, jt.SMALL_CARDS, jt.TINY_CARDS) == (mt.BIG_CARDS, mt.SMALL_CARDS,
                                                             common.TINY_CARDS)
    off = np.concatenate([[0], np.cumsum(np.asarray(jt.SMALL_CARDS) + 1)])
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        want = np.concatenate([off[i] + (r.zipf(1.05, BATCH) % c)
                               for i, c in enumerate(jt.SMALL_CARDS)]).astype(np.int32)
        np.testing.assert_array_equal(common.zipf_slots(seed, off[:-1], mt.SMALL_CARDS, BATCH),
                                      want)
        r = np.random.default_rng(seed)
        want = np.concatenate([r.zipf(1.05, BATCH) % c for c in jt.BIG_CARDS]).astype(np.int32)
        np.testing.assert_array_equal(
            common.zipf_slots(seed, [0] * len(mt.BIG_CARDS), mt.BIG_CARDS, BATCH), want)


def test_flat_truth_matches_gen_flat():
    values, scales = common.gen_flat(3000, "cpu")
    slots = np.random.default_rng(3).integers(0, 3000, 500).astype(np.int32)
    t = torch.from_numpy(slots)
    for mode, want in (("device", gather_dequant(values, scales, t)),
                       (0.013, gather_dequant(values, None, t, torch.full((500,), 0.013))),
                       (None, gather_dequant(values, None, t))):
        np.testing.assert_array_equal(common.flat_truth(slots, mode), want.numpy())


def test_microbench_onehot_checks_pass_on_cpu():
    lines = []
    mo.run("cpu", batch=BATCH, n_sets=2, card_sets={"a": [5, 600, 30], "b": [5, 600, 30, 1100]},
           m_tiles=(32, 64), v1_m_tile=64, emit=lines.append)
    assert [(ln["what"], ln["cards"], ln["m_tile"]) for ln in lines] == [
        ("K6 v2", "a", 32), ("K6 v2", "a", 64), ("K6 v1", "a", 64),
        ("K6 v2", "b", 32), ("K6 v2", "b", 64)]
    assert all(not any(ln["check"].values()) and "us_per_batch" not in ln for ln in lines)


def test_microbench_true_checks_pass_on_cpu():
    lines = mt.run("cpu", batch=BATCH, n_sets=2, big_cards=[3000, 700],
                   small_cards=mt.SMALL_CARDS[:4], tiny_cards=common.TINY_CARDS[:5],
                   onehot_m_tile=BATCH, emit=lambda line: None)
    assert [ln["config"] for ln in lines] == list("ABCDEFGHIJ") + ["J'"]
    assert all("us_per_batch" not in ln for ln in lines)


def test_onehot_matmul_yardstick_equals_k1():
    arena = common.build_arena([5, 600, 30], common.R_TILE, "cpu")
    _, slots = arena.slots(4, BATCH)
    assert torch.equal(mo.onehot_matmul(arena, slots, BATCH),
                       gather_dequant(arena.values, None, slots))


def test_timing_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        common.graph_us([lambda: None])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mo.run(batch=BATCH, n_sets=1, emit=lambda line: None)


def test_kernel_timing_scripts_need_a_card():
    """The predict-kernel timer and the phase split refuse to run without a
    card (a CPU time is no device metric); the phase split also refuses a
    kernel that is not the warp-per-sample one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hugectr_backend_tpu_torch.scripts import k3_phase_split, predict_kernels

    root = Path(__file__).resolve().parent.parent
    assert predict_kernels.main(["--tree", str(root)]) == 2
    assert k3_phase_split.main(["--tree", str(root)]) == 2
    src = (root / "hugectr_backend_tpu_torch/csrc/dot_interaction.cu").read_text()
    with pytest.raises(ValueError, match="warp-per-sample"):
        k3_phase_split.stamped_source(src)
