"""The port's ``microbench_interaction`` against the JAX package's script
(imported by path): its constants and top-layer weights, and the variants'
outputs at batch 64 against the JAX script's formulations (f32 math on the
same bf16-rounded z, as its CPU smoke runs them) and against the Pallas K4
body in interpret mode (bf16). On the CPU.

Tolerances: variants B, C and E equal the JAX script's B bit for bit up to
f32 summation order (rtol 1e-6, atol 1e-6 x max|z|^2); D's fold within rel
1e-5 of its gather + matmul; K4 / K2 at bf16 within 1 bf16 ulp of the Pallas
body (tests/test_torch_compute_dtype.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu_torch.scripts import microbench_interaction as mi

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
BATCH = 64


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_microbench_interaction", ROOT / "scripts" / "microbench_interaction.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_weights_match_the_jax_script(jax_script):
    assert (mi.T, mi.DIM, mi.F, mi.N_INTER, mi.TOP_W) == (
        jax_script.T, jax_script.DIM, jax_script.F, jax_script.N_INTER, jax_script.TOP_W)
    np.testing.assert_array_equal(mi.ROWS_NP, jax_script.ROWS_NP)
    np.testing.assert_array_equal(mi.COLS_NP, jax_script.COLS_NP)
    w, w_exp = mi.top_weights()
    # The JAX script's draws (microbench_interaction.py:106-110).
    rng = np.random.default_rng(0)
    jw = rng.standard_normal((jax_script.N_INTER, jax_script.TOP_W)).astype(np.float32) * 0.05
    np.testing.assert_array_equal(w, jw)
    r, c = jax_script.ROWS_NP, jax_script.COLS_NP
    np.testing.assert_array_equal(w_exp[r * mi.F + c], jw / 2)
    np.testing.assert_array_equal(w_exp[c * mi.F + r], jw / 2)


def test_variants_match_the_jax_formulations(one_torch_thread):
    z = mi.z_sets(BATCH, "cpu", 1)[0]
    zj = jnp.asarray(z.float().numpy())
    ein = jnp.einsum("bfd,bgd->bfg", zj, zj, preferred_element_type=jnp.float32)
    rows, cols = jnp.asarray(mi.ROWS_NP), jnp.asarray(mi.COLS_NP)
    want_b = np.asarray(ein[:, rows, cols])
    fns = mi.variants("cpu")
    zm = float(np.abs(np.asarray(zj)).max())
    with torch.inference_mode():
        for name in ("B_fancy_index", "C_flat_index_select", "E_strided_slices"):
            np.testing.assert_allclose(fns[name](z).numpy(), want_b, rtol=1e-6,
                                       atol=1e-6 * zm * zm)
        errs = mi.check(fns, z)
        k4 = fns["K4_bf16"](z)
    assert set(errs) >= {"A_product_only", "B_fancy_index", "K4_bf16", "K2_bf16",
                         "D_fold_matmul"}
    want_k4 = np.asarray(jfi.fused_dot_interaction(jnp.asarray(z.float().numpy(), jnp.bfloat16)
                                                   [:, 0], jnp.asarray(z.float().numpy(),
                                                                       jnp.bfloat16)[:, 1:],
                                                   True).astype(jnp.float32))
    got = k4.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want_k4), 2.0 ** -126))) - 7)
    assert k4.dtype == torch.bfloat16 and (np.abs(got - want_k4) <= ulp).all()


def test_run_checks_itself_on_the_cpu(one_torch_thread):
    lines = mi.run("cpu", batch=BATCH, emit=lambda line: None)
    assert [ln["variant"] for ln in lines] == list(mi.variants("cpu"))
    assert all("us" not in ln for ln in lines)
