"""The port's ``microbench_dense`` and ``microbench_w8a8_kernel`` against the
JAX package's scripts (imported by path; their ``main`` is guarded): the
FLOP accounting, the shapes and weights, and the stages' outputs at batch
64 against the JAX modules on the same inputs. On the CPU.

Tolerances: K5's plain version and the ``_int_mm`` formulation equal the
JAX package's ``xla_w8a8`` bit for bit (an exact int32 sum, then the same
IEEE steps). The dense stages: the MLPs are f32 products summed in other
orders (rtol 1e-5, atol 1e-6 x max|want|); full forwards as in
tests/test_torch_bench.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models import quant_dense as jqd
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.models.dlrm import MLP as FlaxMLP
from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu.ops.quant_matmul import xla_w8a8
from hugectr_backend_tpu_torch import bench
from hugectr_backend_tpu_torch.models.dlrm import load_flax_dlrm_params
from hugectr_backend_tpu_torch.scripts import microbench_dense as md
from hugectr_backend_tpu_torch.scripts import microbench_w8a8_kernel as mw

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_dense():
    return _load("microbench_dense")


@pytest.fixture(scope="module")
def jax_w8a8():
    return _load("microbench_w8a8_kernel")


def test_flop_accounting_matches_the_jax_script(jax_dense):
    assert md.MACS == jax_dense.MACS
    assert md.MACS["total"] == 2_458_496
    assert (md.T, md.DIM, md.ND, md.INTER_OUT) == (jax_dense.T, jax_dense.DIM, jax_dense.ND,
                                                   jax_dense._inter_out)
    assert (tuple(bench.BOTTOM), tuple(bench.TOP)) == (jax_dense.BOTTOM, jax_dense.TOP)
    assert round(2 * md.MACS["total"] * 4096 / 1e9, 1) == 20.1


def test_dense_run_checks_itself_on_the_cpu(one_torch_thread):
    lines = md.run("cpu", batch=BATCH, emit=lambda line: None)
    stages = [ln["stage"] for ln in lines if "stage" in ln]
    assert stages[:5] == [f for f, _, _ in md.FULL]
    assert {"E_bottom", "G_top"} <= set(stages)
    assert sum(s.startswith("F_interaction_") for s in stages) == 6
    assert all("us" not in ln for ln in lines)  # no time on the CPU
    assert lines[-1]["flop_per_batch_g"] == 2 * md.MACS["total"] * BATCH / 1e9


def test_dense_stages_match_flax(one_torch_thread, monkeypatch):
    """Stages A-D and H (the full forwards on the benchmark's folded feature
    layout), E and G against the Flax modules on parameters carried
    across."""
    tables = md.onehot_tables("cpu")
    inp = md.Inputs(tables, BATCH, 0, "cpu")
    flax_f32 = FlaxDLRM(bottom_widths=bench.BOTTOM)
    params = flax_f32.init(jax.random.PRNGKey(1), jnp.zeros((BATCH, md.ND)),
                           jnp.zeros((BATCH, md.T, md.DIM)))
    model = bench.make_model(md.T)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    variants = bench.make_variants(model)
    n_oh = len(tables.oh_cards)
    jemb = jfi.EmbParts([jnp.asarray(p.numpy()) for p in inp.parts], inp.fmap, BATCH,
                        oh=(jnp.asarray(tables.oh_vals.numpy()), jnp.asarray(inp.slots.numpy()),
                            jnp.asarray(inp.scales.numpy()), tables.oh_members))
    assert n_oh == 14 and len(inp.fmap) == 12
    dense = jnp.asarray(inp.dense.numpy())
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    tol = {"f32": 1e-4, "int8": 1e-4, "fp8": 1e-4, "w8a8": 1e-2,
           "bf16cast": bench.VARIANT_TOL["bf16cast"]}
    with torch.inference_mode():
        for stage, variant, _ in md.FULL:
            if variant == "bf16cast":
                fm, fp = FlaxDLRM(bottom_widths=bench.BOTTOM, compute_dtype=jnp.bfloat16), params
            elif variant == "f32":
                fm, fp = flax_f32, params
            else:
                fm = FlaxDLRM(bottom_widths=bench.BOTTOM, quant_fmt=variant)
                fp = jqd.quantize_model_params(params, variant)
            want = np.asarray(fm.apply(fp, dense, jemb))
            got = variants[variant][0](inp.dense, inp.emb()).float().numpy()
            assert bench.rel_err(got, want) <= tol[variant], (stage, bench.rel_err(got, want))
        p = params["params"]
        for name, mlp, fmlp, x in (
                ("E", model.bottom, FlaxMLP(bench.BOTTOM), inp.dense),
                ("G", model.top, FlaxMLP(bench.TOP, final_activation=False),
                 torch.from_numpy(np.random.default_rng(3).standard_normal(
                     (BATCH, md.INTER_OUT)).astype(np.float32)))):
            want = np.asarray(fmlp.apply({"params": p["MLP_0" if name == "E" else "MLP_1"]},
                                         jnp.asarray(x.numpy())))
            got = mlp(x).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_w8a8_shapes_and_weights_match_the_jax_script(jax_w8a8):
    assert mw.SHAPES == jax_w8a8.SHAPES and mw.BATCH == jax_w8a8.BATCH
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for k, n in mw.SHAPES:
        wq, ws, b = mw.weights(rng, k, n, "cpu")
        # The JAX script's draws, in its order (microbench_w8a8_kernel.py:82-84).
        jwq = jnp.asarray(jrng.integers(-127, 128, (k, n)), jnp.int8)
        jws = jnp.asarray(jrng.random(n, np.float32) * 0.02 + 0.001)
        jb = jnp.asarray(jrng.random(n, np.float32) * 0.1)
        np.testing.assert_array_equal(wq.numpy().T, np.asarray(jwq))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("k, n", [(512, 256), (13, 512), (479, 1024), (256, 1)])
def test_w8a8_formulations_match_xla_w8a8(one_torch_thread, k, n):
    """K5's plain version and the ``_int_mm`` formulation against the JAX
    package's ``xla_w8a8`` (relu) on the same activations."""
    wq, ws, b = mw.weights(np.random.default_rng(k + n), k, n, "cpu")
    x = mw.activations(k, BATCH, 1, "cpu")
    # The JAX script's activations: sin(0.37 col + 0.011 row + seed).
    col = np.arange(k, dtype=np.float32)[None, :]
    row = np.arange(BATCH, dtype=np.float32)[:, None]
    np.testing.assert_allclose(x.numpy(), np.sin(col * np.float32(0.37) + row * np.float32(0.011)
                                                 + np.float32(1.0)), atol=1e-5)
    want = np.asarray(xla_w8a8(jnp.asarray(x.numpy()), jnp.asarray(wq.numpy().T),
                               jnp.asarray(ws.numpy()), jnp.asarray(b.numpy()), act="relu"))
    np.testing.assert_array_equal(mw.w8a8_dense_plain(x, wq, ws, b, "relu").numpy(), want)
    np.testing.assert_array_equal(mw.IntMmW8a8(wq, ws, b, k)(x).numpy(), want)
    # The serving layout: the weight's rows zero-padded to 16 columns.
    wp, _, _ = mw.weights(np.random.default_rng(k + n), k, n, "cpu", pad16=True)
    assert wp.shape[1] % 16 == 0 and torch.equal(wp[:, :k], wq) and not wp[:, k:].any()
    np.testing.assert_array_equal(mw.w8a8_dense_plain(x, wp, ws, b, "relu").numpy(), want)


def test_w8a8_run_checks_itself_on_the_cpu(one_torch_thread):
    lines = mw.run("cpu", batch=BATCH, emit=lambda line: None)
    assert [(ln["k"], ln["n"]) for ln in lines] == (mw.SHAPES + mw.DLRM_LAYERS
                                                     + [(13, 512), (479, 1024)] * 2)
    at_479 = [(ln["shape"], ln["weight_row_bytes"], ln["k5_weight_row_bytes"])
              for ln in lines if ln["k"] == 479]
    # The layer keeps its rows as stored and hands K5 the padded copy.
    assert at_479 == [("dlrm_layer", 480, 480), ("dlrm_layer_unpadded", 479, 479),
                      ("quant_dense_unpadded", 479, 480)]
    assert all("k5_us" not in ln for ln in lines)


def test_w8a8_bound_counts_bytes_and_int8_operations():
    t, by = mw.bound(4096, 1024, 1024, 3.35e12, 1979e12)
    assert by == "bytes"
    assert t == pytest.approx((4 * 4096 * 1024 + 1024 * 1024 + 8 * 1024 + 4 * 4096 * 1024)
                              / 3.35e12 * 1e6)
