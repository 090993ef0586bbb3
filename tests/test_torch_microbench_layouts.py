"""The port's nine TPU-layout microbenchmarks against the JAX package's
scripts and against the JAX package itself, on the CPU.

- **Layouts.** Each port script builds what its JAX twin builds: the
  cardinalities and the one-hot / arena / solo split, the one-hot members'
  ``pad128`` offsets, the interleaved feature map and its part-major order,
  the slot counts and table sizes, the Zipf slots. The guarded JAX scripts
  are imported by path (their ``main`` is not run); the three that run on
  import (``microbench_oh_fused.py``, ``microbench_pallas_parts.py``,
  ``microbench_parts_fm.py``) are never imported or executed: their literal
  assignments are read with ``ast.literal_eval``, and the two index lists
  that are expressions over those literals (``oh_idx``, ``ar_idx``) are
  evaluated alone, with ``range`` and ``list`` as their only names.
- **The slice against the JAX package** (B 64, narrow widths,
  ``HPS_PALLAS_INTERPRET=1`` so that the Flax DLRM runs the Pallas bodies
  interpreted): ``microbench_pallas_parts``' three legs and
  ``microbench_parts_fm``'s two K2 legs against ``DLRM.apply`` on
  ``EmbParts``, the weights carried by ``load_flax_dlrm_params``, at rtol
  1e-4 / atol 1e-5 (the port's DLRM-vs-Flax bar, tests/test_torch_dlrm.py:
  f32 MLPs in another sum order); ``microbench_oh_fused``'s two legs
  against ``fused_dot_interaction_oh_parts`` and against
  ``onehot_member_rows`` + ``fused_dot_interaction_parts`` at rtol 1e-5,
  atol 1e-6 * max|z|^2 (both round z to bf16; only the f32 sum order
  differs).
- **The correctness steps.** Each script's ``run("cpu", ...)`` passes at a
  small batch (``chip_smoke.LAYOUT_SMOKE``'s sizes), and chip_smoke's phase
  13 rehearses on the CPU.
- **The launch plan keyword.** ``plan=None`` is ``k3_plan``'s plan; every
  plan of ``k3_plans`` is taken and gives the same output; a plan the
  kernel would refuse raises, on the CPU too.
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from hugectr_backend_tpu.cache.lookup_program import onehot_member_rows
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu.ps import parameter_server as jps
from hugectr_backend_tpu_torch import bench
from hugectr_backend_tpu_torch.models.dlrm import load_flax_dlrm_params
from hugectr_backend_tpu_torch.ops import fused_interaction as tfi
from hugectr_backend_tpu_torch.scripts import common
from hugectr_backend_tpu_torch.scripts import microbench_fold_ab as mfa
from hugectr_backend_tpu_torch.scripts import microbench_full_ab as mfu
from hugectr_backend_tpu_torch.scripts import microbench_geometry as mg
from hugectr_backend_tpu_torch.scripts import microbench_int8_onehot as mi8
from hugectr_backend_tpu_torch.scripts import microbench_oh_fused as moh
from hugectr_backend_tpu_torch.scripts import microbench_overlap as mov
from hugectr_backend_tpu_torch.scripts import microbench_pallas_interaction as mpi
from hugectr_backend_tpu_torch.scripts import microbench_pallas_parts as mpp
from hugectr_backend_tpu_torch.scripts import microbench_parts_fm as mfm

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64
NARROW = {"bottom": (16, 16), "top": (32, 1)}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts(monkeypatch_module):
    monkeypatch_module.delenv("HPS_BENCH_SMOKE", raising=False)
    return {name: _load(name) for name in (
        "microbench_pallas_interaction", "microbench_fold_ab", "microbench_full_ab",
        "microbench_int8_onehot", "microbench_geometry", "microbench_overlap")}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _assigned(name: str) -> dict:
    """The top-level assignments of an unguarded JAX script, read from its
    source: literals by ``ast.literal_eval``, and ``oh_idx`` / ``ar_idx``
    (expressions over them) evaluated alone with ``range`` and ``list``."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    env = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        targets = node.targets[0]
        names = ([t.id for t in targets.elts] if isinstance(targets, ast.Tuple)
                 else [targets.id] if isinstance(targets, ast.Name) else [])
        if not names:
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            if names[0] not in ("oh_idx", "ar_idx", "BOTTOM"):
                continue
            code = compile(ast.Expression(node.value), name, "eval")
            value = eval(code, {"__builtins__": {"range": range, "list": list}, **env})
        if len(names) > 1:
            env.update(zip(names, value))
        else:
            env[names[0]] = value
    return env


def _jax_fmap(oh_idx, ar_idx, t):
    """The JAX scripts' loop that builds the interleaved map."""
    fmap = [None] * t
    for j, x in enumerate(oh_idx):
        fmap[x] = (0, j)
    for j, x in enumerate(ar_idx):
        fmap[x] = (1, j)
    return tuple(fmap)


# ----------------------------------------------------------------- layouts


def test_cardinalities_and_split_match_the_jax_scripts(jax_scripts):
    cards = jax_scripts["microbench_fold_ab"].CRITEO_CARDS
    assert cards == common.CRITEO_CARDS == jax_scripts["microbench_full_ab"].CRITEO_CARDS
    assert list(bench.CRITEO_CARDS) == cards
    onehot, arena = jps.onehot_member_max_rows(), jps.arena_member_max_rows()
    full = jax_scripts["microbench_full_ab"]
    assert (full.ONEHOT_MAX, full.ARENA_MAX) == (onehot, arena)
    want = ([t for t, c in enumerate(cards) if c + 1 <= onehot],
            [t for t, c in enumerate(cards) if c + 1 > onehot and c <= arena],
            [t for t, c in enumerate(cards) if c > arena])
    assert tuple(common.grouping(cards)) == want
    oh, ar, big = ([cards[t] for t in g] for g in want)
    assert common.OH_CARDS == oh == jax_scripts["microbench_int8_onehot"].OH_CARDS
    assert common.OH_CARDS == _assigned("microbench_oh_fused")["OH_CARDS"]
    assert common.BIG_CARDS == jax_scripts["microbench_overlap"].BIG_CARDS
    assert sorted(common.BIG_CARDS) == sorted(big)
    assert common.SMALL_CARDS == jax_scripts["microbench_overlap"].SMALL_CARDS
    assert common.SMALL_CARDS == [c for c in cards if c <= arena]
    assert [len(g) for g in want] == [14, 4, 8]


def test_fold_and_full_ab_layouts_match_the_jax_scripts():
    """fold_ab: one-hot members aligned to 128 rows, the arena unaligned
    (bench.CriteoTables); full_ab: both unaligned (its ``layout``)."""
    cards = common.CRITEO_CARDS
    oh_idx, ar_idx, _ = common.grouping(cards)
    for idx, align in ((oh_idx, 128), (ar_idx, 1), (oh_idx, 1)):
        cs = [cards[t] for t in idx]
        blocks = [-(-(c + 1) // align) * align for c in cs]
        off, total = common.arena_layout(cs, align)
        np.testing.assert_array_equal(off, np.concatenate([[0], np.cumsum(blocks)]))
        assert total == sum(blocks)
    lk = mfu.FullLookup([min(c, 70_000) for c in cards], "cpu")
    np.testing.assert_array_equal(lk.oh_off, np.concatenate(
        [[0], np.cumsum(np.asarray(lk.oh_cards) + 1)]))


def test_oh_fused_geometry_matches_the_jax_script():
    env = _assigned("microbench_oh_fused")
    assert (env["B"], env["D"], env["N_AR"], env["N_SOLO"]) == (moh.B, moh.D, moh.N_AR,
                                                               moh.N_SOLO)
    tree = ast.parse((ROOT / "scripts" / "microbench_oh_fused.py").read_text())
    pad = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "pad128")
    assert ast.unparse(pad.body[0]) == "return -(-n // 128) * 128"
    sizes = [-(-(c + 1) // 128) * 128 for c in env["OH_CARDS"]]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    members, rows = moh.members()
    assert members == tuple((int(offs[j]), sizes[j]) for j in range(len(sizes)))
    assert rows == int(offs[-1])
    assert all(o % 128 == 0 and s % 128 == 0 for o, s in members)


@pytest.mark.parametrize("script", ["microbench_pallas_parts", "microbench_parts_fm"])
def test_interleaved_map_and_widths_match_the_jax_script(script):
    env = _assigned(script)
    assert (env["B"], env["T"], env["D"], env["ND"]) == (mpp.B, mpp.T, mpp.D, mpp.ND)
    assert (env["n_oh"], env["n_ar"]) == (mpp.N_OH, mpp.N_AR)
    assert env["BOTTOM"] == mpp.BOTTOM and env["TOP"] == mpp.TOP
    assert env["oh_idx"] == mpp.OH_IDX and env["ar_idx"] == mpp.AR_IDX
    fmap = _jax_fmap(env["oh_idx"], env["ar_idx"], env["T"])
    assert fmap == mpp.FMAP
    order, fm = jfi.part_major_order(fmap)
    t_order, t_fm = tfi.part_major_order(mpp.FMAP)
    assert list(order) == list(t_order) and tuple(fm) == tuple(t_fm)
    assert jfi.is_part_major(t_fm) and not jfi.is_part_major(mpp.FMAP)


def test_shapes_and_slots_match_the_guarded_jax_scripts(jax_scripts):
    jpi = jax_scripts["microbench_pallas_interaction"]
    assert (jpi.BATCH, jpi.T, jpi.DIM) == (mpi.BATCH, mpi.T, mpi.DIM)
    jg = jax_scripts["microbench_geometry"]
    assert tuple(jg.SLOT_COUNTS) == mg.SLOT_COUNTS and jg.ROWS_BIG == mg.ROWS_BIG
    assert set(mg.ROWS) - {mg.ONEHOT_MAX_ROWS} == {16_384, 131_072, 1_048_576, jg.ROWS_BIG}
    for seed in (1, 4):
        np.testing.assert_array_equal(mg.slots_for(seed, 16_384, 1024),
                                      np.asarray(jg.slots_for(seed, 16_384, 1024)))
    jo = jax_scripts["microbench_overlap"]
    for got, want in zip(mov.make_slots(3, common.BIG_CARDS, BATCH),
                         jo.make_slots(3, common.BIG_CARDS, BATCH)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert jax_scripts["microbench_int8_onehot"].BATCH == common.BATCH


# ------------------------------------------------- the slice against JAX


def _flax(batch, dim, top, seed=1):
    flax = FlaxDLRM(bottom_widths=(16, dim), top_widths=top)
    params = flax.init(jax.random.PRNGKey(seed), jnp.zeros((batch, mpp.ND)),
                       jnp.zeros((batch, mpp.T, dim)))
    return flax, params, load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params))


def test_pallas_parts_and_parts_fm_legs_match_the_flax_dlrm(one_torch_thread, monkeypatch):
    dim, top = NARROW["bottom"][-1], NARROW["top"]
    flax, params, state = _flax(BATCH, dim, top)
    model = mpp.make_model("cpu", state, **NARROW)
    dense, oh, ar = mpp.sources(BATCH, "cpu", 1, dim)[0]
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    parts = [jnp.asarray(oh.numpy()), jnp.asarray(ar.numpy())]
    jd = jnp.asarray(dense.numpy())
    want = np.asarray(flax.apply(params, jd, jfi.EmbParts(parts, mpp.FMAP)))
    order, fmap_fm = jfi.part_major_order(mpp.FMAP)
    want_fm = np.asarray(flax.apply(jfi.permute_dlrm_top_params(params, order, dim), jd,
                                    jfi.EmbParts(parts, fmap_fm)))
    np.testing.assert_allclose(want_fm, want, rtol=1e-4, atol=1e-5)
    with torch.inference_mode():
        for name, fn in mpp.legs(model).items():
            np.testing.assert_allclose(fn(dense, oh, ar)[1].numpy(), want, rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        got_fmap, fm = mfm.fm_leg(model)
        assert tuple(got_fmap) == tuple(fmap_fm)
        np.testing.assert_allclose(fm(dense, oh, ar)[1].numpy(), want_fm, rtol=1e-4, atol=1e-5)


def test_oh_fused_legs_match_the_jax_kernels(one_torch_thread):
    st = moh.Stage(BATCH, "cpu", dim=16)
    sl, sc = st.slots(0), st.scales(0)
    jb, ja = jnp.asarray(st.bottom.numpy()), jnp.asarray(st.arena.numpy())
    jsl, jsc = jnp.asarray(sl.numpy()), jnp.asarray(sc.numpy())
    jparts = tuple(jnp.asarray(p.numpy()) for p in st.parts)
    fused = np.asarray(jfi.fused_dot_interaction_oh_parts(
        jb, ja, jsl, jsc, jparts, members=st.members, interpret=True))
    rows = jnp.stack([onehot_member_rows(ja, off, size, jsl[j]) * jsc[j][:, None]
                      for j, (off, size) in enumerate(st.members)])
    two = np.asarray(jfi.fused_dot_interaction_parts(jb, [rows, *jparts], st.fmap2, True))
    feats = [st.bottom.numpy(), np.asarray(rows).reshape(-1, 16)] + [p.numpy() for p in st.parts]
    zm = max(float(np.abs(f).max()) for f in feats)
    with torch.inference_mode():
        got_fold, got_two = st.oh_in_kernel(sl, sc).numpy(), st.two_stage(sl, sc).numpy()
    for got in (got_fold, got_two):
        for want in (fused, two):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * zm * zm)


# ------------------------------------------------------ correctness steps


_MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (mpi, mpp, mfm, moh, mfa, mfu, mi8, mg,
                                                       mov)}


@pytest.mark.parametrize("name", sorted(_MODULES))
def test_correctness_step_runs_on_the_cpu(one_torch_thread, name):
    kw = dict(chip_smoke.LAYOUT_SMOKE[name])
    if name == "microbench_fold_ab":
        kw["cards"] = chip_smoke._CAPPED
    lines = []
    out = _MODULES[name].run("cpu", emit=lines.append, **kw)
    assert out == lines and out
    assert all(ln["device"] == "cpu" and "us" not in ln for ln in out)


def test_chip_smoke_layouts_rehearsal(one_torch_thread, capsys):
    res = chip_smoke.microbench_layouts_phase(torch.device("cpu"), emit_line=lambda ln: None,
                                              smoke=True)
    assert set(res["lines"]) == set(_MODULES)
    assert res["launches"] == {} and res["peak_gb"] is None
    assert "microbench_overlap:" in capsys.readouterr().out


# ------------------------------------------------------ the plan keyword


def _wrappers():
    rng = np.random.default_rng(0)
    b, d = 16, 16
    bottom = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((b, 3, d)).astype(np.float32))
    arena = torch.from_numpy(rng.integers(-127, 128, (256, d)).astype(np.int8))
    slots = torch.from_numpy(rng.integers(0, 256, (2, b)).astype(np.int32))
    scales = torch.full((2, b), 0.01)
    return {
        "fused_dot_interaction": (4, lambda plan: tfi.fused_dot_interaction(
            bottom, emb, plan=plan)),
        "dot_interaction_parts": (4, lambda plan: tfi.dot_interaction_parts(
            bottom, [emb.transpose(0, 1)], ((0, 0), (0, 1), (0, 2)), plan=plan)),
        "dot_interaction_oh_parts": (6, lambda plan: tfi.dot_interaction_oh_parts(
            bottom, arena, slots, scales, [emb.transpose(0, 1)], ((0, 0), (0, 1), (0, 2)),
            plan=plan)),
    }


@pytest.mark.parametrize("name", ["fused_dot_interaction", "dot_interaction_parts",
                                  "dot_interaction_oh_parts"])
def test_plan_keyword(name):
    feats, call = _wrappers()[name]
    d, b = 16, 16
    default = tfi.k3_plan(b, feats, d)
    want = call(None)
    assert torch.equal(call(default), want)
    plans = tfi.k3_plans(b, feats, d)
    assert default in plans and len(plans) == 8
    for p in plans:
        assert torch.equal(call(p), want)
    bad = [default._replace(warps=0), default._replace(warps=9), default._replace(grid=0),
           default._replace(smem=default.smem + 16), (default.warps, default.smem, 1, 1),
           tfi.K3WidePlan(1, 256, 32, 16, 0), tfi.K3WidePlan(1, 128, 16, 16, 0)]
    for p in bad:
        with pytest.raises(ValueError, match="takes no plan"):
            call(p)


def test_k3_plan_is_the_best_of_k3_plans():
    for b, f, d in ((4096, 27, 128), (37, 5, 36), (4096, 300, 128), (8, 2, 4)):
        plans = tfi.k3_plans(b, f, d)
        best = max(plans, key=lambda p: (p.ctas_per_sm * p.warps, p.warps))
        assert tfi.k3_plan(b, f, d) == best
    assert tfi.k3_plan(4096, 27, 128) == tfi.K3Plan(8, 83328, 264, 2)
