"""The PyTorch DLRM against the Flax DLRM of the JAX package, on weights
carried across by ``load_flax_dlrm_params``.

Tolerance: rtol 1e-4 / atol 1e-5, the bar of the JAX package's own fused-model
tests. The Flax model runs with ``HPS_PALLAS_INTERPRET=1``, so its
interaction is the Pallas body (z rounded to bf16, f32 sums) like the port's;
the MLPs are f32 on both sides and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.models.dlrm import DotInteraction as FlaxDot
from hugectr_backend_tpu_torch.models.dlrm import DLRM, DotInteraction, load_flax_dlrm_params


@pytest.mark.parametrize("b, d, tables", [(8, 32, 4), (16, 128, 3)])
def test_dlrm_logits_match_flax(monkeypatch, b, d, tables):
    nd = 5
    flax_model = FlaxDLRM(bottom_widths=(16, d), top_widths=(32, 16, 1))
    rng = np.random.default_rng(b + d)
    dense = rng.standard_normal((b, nd)).astype(np.float32)
    emb = rng.standard_normal((b, tables, d)).astype(np.float32)
    params = flax_model.init(jax.random.PRNGKey(b), jnp.zeros((b, nd)),
                             jnp.zeros((b, tables, d)))
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    want = np.asarray(flax_model.apply(params, jnp.asarray(dense), jnp.asarray(emb)))

    model = DLRM(nd, tables, bottom_widths=(16, d), top_widths=(32, 16, 1))
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    assert got.shape == want.shape == (b,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_self_interaction_matches_flax():
    """k = 0 stays plain f32 on both sides (no kernel in either package)."""
    rng = np.random.default_rng(3)
    bottom = rng.standard_normal((6, 8)).astype(np.float32)
    emb = rng.standard_normal((6, 3, 8)).astype(np.float32)
    flax_dot = FlaxDot(self_interaction=True)
    want = np.asarray(flax_dot.apply({}, jnp.asarray(bottom), jnp.asarray(emb)))
    got = DotInteraction(self_interaction=True)(torch.from_numpy(bottom),
                                                torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_load_refuses_quantized_layers():
    tree = {"params": {"MLP_0": {"QuantDense_0": {}}, "MLP_1": {"Dense_0": {}}}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_flax_dlrm_params(tree)
