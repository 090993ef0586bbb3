"""The bias of a bf16 product, added after the product is rounded, as Flax
adds it: the nine zoo families and the DLRM at ``compute_dtype`` bf16, and
the port's ``models.dlrm.dense`` alone, against the Flax models on
parameters carried across, with biases of 0.1 N(0, 1) drawn from a seed.
The tests run on one torch thread (``one_torch_thread``).

Flax's ``nn.Dense(dtype=bfloat16)`` multiplies the bf16 operands, sums in
f32, rounds the product to bf16, and then adds the bias in bf16. Adding the
bias to the f32 sum and rounding once (``F.linear`` with its bias, which
the port did before) is another result wherever a bias is not zero. Flax
initialises every bias to zero, so the bf16 tests of
``test_torch_zoo_compute_dtype.py``, which take Flax's init, cannot tell the
two orders apart; a trained checkpoint can.

The bar is that file's ``BAR`` (2^-20 of the largest output). Readings, the
port against Flax on this file's inputs: every output equal, bit for bit,
for eight families, the DLRM and each ``dense`` shape; DeepFM 8.5e-8 of its
largest logit (its f32 first-order and FM sums, added in another order).
The bias-before-rounding formulation parts from Flax by 1.8e-4 (DeepFM) to
1.1e-2 (DCN-v2) of the largest output, and by 3.7e-3 to 6.9e-3 at the
``dense`` shapes (``test_bar_rejects_bias_before_rounding``).
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu_torch.models import dlrm as tdlrm
from hugectr_backend_tpu_torch.models.dlrm import DLRM, dense, load_flax_dlrm_params
from hugectr_backend_tpu_torch.scripts.microbench_zoo_dtypes import (
    MODEL_MODULES,
    dense_before_repair as _bias_before_rounding,
)

from test_torch_zoo_compute_dtype import BAR, FAMILIES, _f32, _inputs, _rel, _run
from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

BF16 = torch.bfloat16
BIAS_STD = 0.1


def _with_biases(params, seed: int):
    """``params`` (a Flax tree) with every bias (``bias``, MMoE's
    ``expert_bias_i``; LayerNorm's too) drawn from 0.1 N(0, 1), as numpy."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias" or name.startswith("expert_bias"):
            return (BIAS_STD * rng.standard_normal(np.shape(leaf))).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(draw, params)


def _family(family, seed):
    """(the Flax model at bf16, its params with biases drawn, the port's
    model at bf16 with them carried across, the inputs)."""
    jmodel, tmodel, load, _ = FAMILIES[family]
    fm = jmodel(jnp.bfloat16)
    xs = _inputs(family, np.random.default_rng(seed))
    params = _with_biases(fm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)), seed + 1)
    model = tmodel(BF16)
    model.load_state_dict(load(params))
    return fm, params, model.eval(), _inputs(family, np.random.default_rng(seed + 2), b=16)


def _patch_dense(monkeypatch, fn):
    """Every model module's ``dense`` (imported by name) replaced by ``fn``."""
    import importlib

    for name in MODEL_MODULES:
        module = importlib.import_module(f"hugectr_backend_tpu_torch.models.{name}")
        monkeypatch.setattr(module, "dense", fn)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_bf16_with_biases_matches_flax(one_torch_thread, family):
    fm, params, model, xs = _family(family, 40)
    want = fm.apply(params, *map(jnp.asarray, xs))
    rel = _rel(_run(model, xs), want)
    assert rel <= BAR, (family, rel)


def _dlrm(seed, b=16, nd=5, tables=4, d=32):
    rng = np.random.default_rng(seed)
    dense_x = rng.standard_normal((b, nd)).astype(np.float32)
    emb = rng.standard_normal((b, tables, d)).astype(np.float32)
    fm = FlaxDLRM(bottom_widths=(16, d), top_widths=(32, 16, 1), compute_dtype=jnp.bfloat16)
    params = _with_biases(fm.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)),
                                  jnp.zeros((b, tables, d))), seed + 1)
    model = DLRM(nd, tables, bottom_widths=(16, d), top_widths=(32, 16, 1),
                 compute_dtype=BF16)
    model.load_state_dict(load_flax_dlrm_params(params))
    return fm, params, model.eval(), [dense_x, emb]


def test_dlrm_bf16_with_biases_matches_flax(one_torch_thread):
    """The bf16 DLRM (its MLPs through ``dense``; the interaction by XLA's
    einsum on the Flax side, K4's plain version on the port's, both f32
    sums of the same bf16 z rounded once) on the stacked embeddings."""
    fm, params, model, xs = _dlrm(41)
    want = fm.apply(params, *map(jnp.asarray, xs))
    rel = _rel(_run(model, xs), want)
    assert rel <= BAR, rel


# (batch, in, out): DCN-v2's first cross layer at the test width, the DLRM's
# bf16 bottom layer 13 -> 512, and the 3341-wide x0 of DCN-v2 into its rank.
SHAPES = [(32, 205, 64), (32, 13, 512), (64, 3341, 64)]


def _dense_case(m, k, n, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    layer = nn.Dense(n, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _with_biases(params, seed + 1)
    lin = torch.nn.Linear(k, n)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(params["params"]["kernel"]).T))
        lin.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
    want = layer.apply(params, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    return torch.from_numpy(x), lin, want


@pytest.mark.parametrize("m,k,n", SHAPES, ids=[f"{m}x{k}to{n}" for m, k, n in SHAPES])
def test_dense_matches_flax_dense(one_torch_thread, m, k, n):
    x, lin, want = _dense_case(m, k, n)
    with torch.no_grad():
        got = dense(x, lin, compute_dtype=BF16)
    assert got.dtype == BF16
    rel = _rel(got, want)
    assert rel <= BAR, rel


def test_dense_rounds_the_product_before_the_bias(one_torch_thread):
    """``dense`` at bf16 is the helper's rounded product plus the bias in
    bf16, and the helper is the f32 product of the bf16 operands rounded
    once, bit for bit."""
    x, lin, _ = _dense_case(16, 205, 64, seed=43)
    with torch.no_grad():
        got = dense(x, lin, compute_dtype=BF16)
        xb, wb = x.to(BF16), lin.weight.to(BF16)
        prod = tdlrm.matmul_f32_sums(xb, wb.T)
        assert torch.equal(prod, (xb.float() @ wb.float().T).to(BF16))
        assert torch.equal(got, prod + lin.bias.to(BF16))
        # batched: q [B, h, T, dk] @ k^T, as BST's attention takes it
        q = torch.randn(2, 3, 5, 8, generator=torch.Generator().manual_seed(1)).to(BF16)
        assert torch.equal(tdlrm.matmul_f32_sums(q, q.transpose(-1, -2)),
                           torch.matmul(q.float(), q.float().transpose(-1, -2)).to(BF16))


def test_f32_sums_hold_tf32_off(monkeypatch):
    """``matmul_f32_sums`` runs its product with TF32 off even where the
    caller turned it on (an f32 SGEMM on the card then sums on the tensor
    cores in TF32), and leaves the caller's setting as it was."""
    seen, real = [], torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.ones(4, 8, dtype=BF16)
        assert torch.equal(tdlrm.matmul_f32_sums(a, a.T), torch.full((4, 4), 8.0, dtype=BF16))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False]


CONTROLS = [("dense", s) for s in SHAPES] + [("family", f) for f in ("dcn", "bst", "mmoe")]


@pytest.mark.parametrize("kind,case", CONTROLS,
                         ids=[c if isinstance(c, str) else f"{c[0]}x{c[1]}to{c[2]}"
                              for _, c in CONTROLS])
def test_bar_rejects_bias_before_rounding(one_torch_thread, monkeypatch, kind, case):
    """``BAR`` tells the two orders apart: the bias added before the one
    rounding parts from Flax by more than the bar on the same inputs."""
    if kind == "dense":
        x, lin, want = _dense_case(*case)
        with torch.no_grad():
            got = _bias_before_rounding(x, lin, compute_dtype=BF16)
        assert _rel(got, want) > BAR
        return
    fm, params, model, xs = _family(case, 40)
    _patch_dense(monkeypatch, _bias_before_rounding)
    want = fm.apply(params, *map(jnp.asarray, xs))
    assert _rel(_run(model, xs), want) > BAR
    assert np.isfinite(_f32(want)).all()
