"""The port's ``bench.py`` against the JAX package's ``bench.py`` (imported by
path; its ``main`` is guarded): the production grouping, the lookup's rows,
the six fused variants' logits, the host stages at smoke sizes, and the
JSON line's keys. Everything runs on the CPU (``device="cpu"``).

Tolerances: the rows are equal bit for bit (the same tables, slots and one
multiply). Logits, |delta| / max|logit|: 1e-4 for f32 and the weight-only
formats (f32 sums in another order through the 8 layers), 1e-2 for w8a8
(one ulp can move a row's int8 quantization a step; tests/
test_torch_quant_dense.py), and ``bench.VARIANT_TOL["bf16cast"]`` for bf16
(2 ulp at each of the 8 layers and 1 at the interaction, compounded;
tests/test_torch_compute_dtype.py).
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.cache.lookup_program import onehot_member_rows
from hugectr_backend_tpu.models import quant_dense as jqd
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu.ps import parameter_server as jps
from hugectr_backend_tpu.tiers.hbm import gather_dequant_xla
from hugectr_backend_tpu_torch import bench
from hugectr_backend_tpu_torch.models.dlrm import load_flax_dlrm_params

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
TOL = {"f32": 1e-4, "f32_twostage": 1e-4, "int8": 1e-4, "fp8": 1e-4, "w8a8": 1e-2,
       "bf16cast": bench.VARIANT_TOL["bf16cast"]}
# A deployment with all three groups at a small size: tables of up to 1,023
# rows one-hot, up to 8,000 in the arena, larger ones solo.
SMALL_CARDS = (1460, 583, 9000, 3, 2900, 24, 7000, 305, 1200, 12000)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grouping_matches_the_jax_bench(jax_bench):
    """14 one-hot, 4 arena, 8 solo at the full cards, as the JAX script's
    policy (bench.py:567-575 over its package's limits)."""
    cards = jax_bench.CRITEO_CARDS
    assert tuple(cards) == tuple(bench.CRITEO_CARDS)
    want = ([t for t, c in enumerate(cards) if c + 1 <= jps.onehot_member_max_rows()],
            [t for t, c in enumerate(cards) if c + 1 > jps.onehot_member_max_rows()
             and c <= jps.arena_member_max_rows()],
            [t for t, c in enumerate(cards) if c > jps.arena_member_max_rows()])
    got = bench.grouping(cards)
    assert got == tuple(want) or list(got) == want
    assert [len(g) for g in got] == [14, 4, 8]
    np.testing.assert_array_equal(
        bench.host_scale(np.arange(1000)),
        jax_bench.host_scale(np.arange(1000)))


@pytest.fixture
def small_state(monkeypatch):
    monkeypatch.setenv("HPS_TPU_ONEHOT_MAX_ROWS", "1024")
    monkeypatch.setenv("HPS_TPU_ARENA_MEMBER_MAX_ROWS", "8000")
    tables = bench.CriteoTables(SMALL_CARDS, "cpu")
    assert [len(g) for g in (tables.oh_idx, tables.ar_idx, tables.big_idx)] == [4, 4, 2]
    return bench.LookupState(tables, 16)


def test_lookup_rows_match_jax(one_torch_thread, small_state):
    """One K1 launch's rows (plain version) equal the JAX bench's
    ``lookup_rows`` (bench.py:630-650): the one-hot members through
    ``onehot_member_rows`` times the host scales, the arena through
    ``gather_dequant_xla`` with device scales, each solo table times its
    host scales; and equal the closed form."""
    st, t, b = small_state, small_state.t, small_state.batch
    outs = st.lookup()
    oh_sl = jnp.asarray(st.host[:len(t.oh_cards) * b])
    oh_sc = jnp.asarray(st.scin[:len(t.oh_cards) * b].numpy())
    vals = jnp.asarray(t.oh_vals.numpy())
    rows = [onehot_member_rows(vals, o, sz, oh_sl[j * b:(j + 1) * b])
            for j, (o, sz) in enumerate(t.oh_members)]
    want = [np.asarray(jnp.concatenate(rows) * oh_sc[:, None])]
    a, z = st.slot_bounds[1]
    want.append(np.asarray(gather_dequant_xla(jnp.asarray(t.ar_vals.numpy()),
                                              jnp.asarray(t.ar_scales.numpy()),
                                              jnp.asarray(st.host[a:z]))))
    for j, v in enumerate(t.big_vals):
        a, z = st.slot_bounds[2 + j]
        c0, c1 = st.scin_bounds[2 + j]
        want.append(np.asarray(gather_dequant_xla(jnp.asarray(v.numpy()), None,
                                                  jnp.asarray(st.host[a:z]))
                               * jnp.asarray(st.scin[c0:c1].numpy())[:, None]))
    assert len(outs) == len(want)
    for g, w, tr in zip(outs, want, st.truth()):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), tr)


def test_bump_stays_inside_each_table(small_state):
    st = small_state
    before = st.slots.clone()
    for x in (torch.tensor([float("nan")]), torch.tensor([float("inf")]),
              torch.tensor([-3.5e38]), torch.tensor([0.0])):
        st.bump(x)
        rel = st.slots - st.bases
        assert bool(((rel >= 0) & (rel < st.mods)).all())
    assert not torch.equal(before, st.slots)


def _jax_emb(st, outs, fold):
    """The JAX bench's EmbParts (bench.py:699-720) over the same rows."""
    t, b = st.t, st.batch
    n_oh = len(t.oh_cards)
    parts, fmap, oh = [], [], None
    if fold:
        oh = (jnp.asarray(t.oh_vals.numpy()), jnp.asarray(st.slots[:n_oh * b].view(n_oh, b)
                                                          .numpy()),
              jnp.asarray(st.scin[:n_oh * b].view(n_oh, b).numpy()), t.oh_members)
    else:
        parts.append(jnp.asarray(outs[0].numpy()).reshape(n_oh, b, -1))
        fmap += [(0, j) for j in range(n_oh)]
    fmap += [(len(parts), j) for j in range(len(t.ar_cards))]
    parts.append(jnp.asarray(outs[1].numpy()).reshape(len(t.ar_cards), b, -1))
    for j in range(len(t.big_cards)):
        fmap.append((len(parts), 0))
        parts.append(jnp.asarray(outs[2 + j].numpy())[None])
    return jfi.EmbParts(parts, fmap, b, oh=oh)


def test_fused_variants_match_jax(one_torch_thread, monkeypatch, small_state):
    """The six variants' logits against the JAX DLRM (Pallas bodies in
    interpret mode) on parameters carried across."""
    st = small_state
    n_tables = len(SMALL_CARDS)
    arch = dict(bottom_widths=bench.BOTTOM)
    flax_f32 = FlaxDLRM(**arch)
    params = flax_f32.init(jax.random.PRNGKey(1), jnp.zeros((st.batch, bench.NUM_DENSE)),
                           jnp.zeros((st.batch, n_tables, bench.DIM)))
    model = bench.make_model(n_tables)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    variants = bench.make_variants(model)
    flax = {"f32": (flax_f32, params), "f32_twostage": (flax_f32, params),
            "bf16cast": (FlaxDLRM(**arch, compute_dtype=jnp.bfloat16), params)}
    for fmt in ("int8", "fp8", "w8a8"):
        flax[fmt] = (FlaxDLRM(**arch, quant_fmt=fmt), jqd.quantize_model_params(params, fmt))
    dense = np.random.default_rng(0).standard_normal((st.batch, bench.NUM_DENSE))
    dense = dense.astype(np.float32)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    assert tuple(variants) == bench.VARIANTS
    with torch.inference_mode():
        for name, (m, fold) in variants.items():
            outs = st.lookup(fold)
            got = bench.variant_logits(st, m, fold, torch.from_numpy(dense)).float().numpy()
            fm, fp = flax[name]
            want = np.asarray(fm.apply(fp, jnp.asarray(dense), _jax_emb(st, outs, fold)))
            assert got.shape == want.shape == (st.batch,)
            assert bench.rel_err(got, want) <= TOL[name], (name, bench.rel_err(got, want))


def _jax_line_keys(jax_bench) -> set:
    """Every key the JAX script's JSON line can hold when every stage
    succeeds (bench.py:955-988, the stage dicts merged into it)."""
    tree = ast.parse(Path(jax_bench.__file__).read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    keys = set()
    for name in ("e2e_serving_stage", "e2e_bigtable_stage", "tier_latency_stage",
                 "host_translate_stage", "main"):
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Dict):
                keys |= {k.value for k in node.keys
                         if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    keys -= {"f32", "samples_us", "median_us", "dram", "ssd", "inputs", "outputs", "name",
             "datatype", "shape", "parameters", "binary_data_size", "binary_data",
             "Content-Type", "Inference-Header-Content-Length", "supportlonglong", "models",
             "model", "sparse_files", "dense_file", "network_file", "max_batch_size",
             "embedding_vecsize_per_table", "maxnum_catfeature_query_per_table_per_sample",
             "default_value_for_each_table", "deployed_device_list", "gpucache",
             "gpucacheper"}
    keys = {k for k in keys if not k.endswith("_error")}
    keys.add("sustained_vectors_per_s")
    for v in ("f32_twostage", "bf16cast", "int8", "fp8", "w8a8"):
        keys |= {f"fused_dlrm_{v}_dense_samples_per_s", f"fused_dlrm_{v}_dense_batch_latency_us"}
    return keys


@pytest.fixture(scope="module")
def smoke_line():
    """The whole benchmark once at the JAX script's smoke sizes on the CPU,
    with ``bench_artifacts/`` listed before and after."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HPS_BENCH_SMOKE", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    art = ROOT / "bench_artifacts"
    before = {p.name: p.stat().st_mtime_ns for p in art.iterdir()}
    lines = []
    try:
        bench.run("cpu", seconds=1.0, emit=lines.append)
    finally:
        torch.set_num_threads(n)
        mp.undo()
    after = {p.name: p.stat().st_mtime_ns for p in art.iterdir()}
    return lines, before, after


def test_smoke_line_holds_every_jax_key(jax_bench, smoke_line):
    (line,), _, _ = smoke_line
    missing = _jax_line_keys(jax_bench) - set(line)
    assert not missing, sorted(missing)
    assert line["device"] == "cpu" and line["batch"] == 128
    # The device keys are null on the CPU, never a CPU number under a
    # device metric's name; the eager keys are measured.
    for k in ("value", "vs_baseline", "batch_latency_us", "fused_dlrm_batch_latency_us",
              "din_pooled_batch_latency_us", "fused_dlrm_w8a8_dense_batch_latency_us"):
        assert line[k] is None, k
    assert line["batch_eager_us"] > 0 and line["fused_dlrm_w8a8_eager_us"] > 0
    assert line["e2e_http_qps"] > 0 and line["e2e_grpc_qps"] > 0
    assert line["e2e_bigtable_qps"] > 0
    assert line["groups"] == {"onehot": 14, "arena": 12, "solo": 0}


def test_host_stages_at_smoke_sizes(smoke_line):
    (line,), _, _ = smoke_line
    assert line["tier_query_keys"] == 512
    assert line["dram_tier_query_us"] > 0 and line["ssd_tier_query_us"] > 0
    assert set(line["tier_spread"]) == {"dram", "ssd"}
    assert line["host_translate_rows"] == sum(min(c, 60_000) for c in bench.CRITEO_CARDS)
    assert line["host_translate_us"] > 0 and line["host_translate_build_s"] > 0


def test_nothing_is_written_under_bench_artifacts(smoke_line):
    _, before, after = smoke_line
    assert before == after


def test_sizes_follow_the_smoke_switch_at_call_time(monkeypatch):
    monkeypatch.delenv("HPS_BENCH_SMOKE", raising=False)
    full = bench.sizes()
    assert (full.batch, full.small_batch, full.it_lo, full.it_hi) == (4096, 1024, 64, 320)
    assert full.cards == tuple(bench.CRITEO_CARDS) and full.din_rows == 1_000_000
    monkeypatch.setenv("HPS_BENCH_SMOKE", "1")
    sm = bench.sizes()
    assert (sm.batch, sm.small_batch, sm.it_lo, sm.it_hi, sm.ab_rounds) == (128, 64, 4, 12, 2)
    assert max(sm.cards) == 60_000 and (sm.din_rows, sm.din_b, sm.din_s) == (20_000, 64, 8)


def test_bench_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.run()
