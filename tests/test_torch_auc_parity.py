"""The AUC-parity harness of the PyTorch port (eval/auc_parity.py) against
the JAX package's: the same datasets, the same AUC, the same gates, and the
single-table fused server (K1 + K4) scoring a checkpoint trained by the JAX
package.

Tolerances:
- datasets and ``auc``: none (numpy code copied as it is: bit-identical).
- harness gates: those of tests/test_auc_parity.py.
- ``FusedDlrmServer`` scores of a carried JAX checkpoint: rtol 1e-4, atol
  1e-5, the bar of the JAX package's fused-model tests. The JAX server runs
  with ``HPS_PALLAS_INTERPRET=1`` (the Pallas K4 body: bf16 z, f32 sums) at
  batches that are multiples of 8.

``run_parity`` trains from the port's own initialisation, drawn from torch
generators, not from the JAX package's PRNG. At the suite size the model
overfits (250 steps over 30,000 samples), and its fp32 AUC depends on the
initialisation seed far more than on the package: in either package some
seeds land below the 0.60 bar and some well above it, and from the JAX
package's own initialisation the port follows the JAX package's steps
(tests/test_torch_train.py). The port's test fixes seed 1, where the model
has learned; the deltas between serving variants are what the gates hold.
"""

import numpy as np
import pytest
import torch

import jax

from hugectr_backend_tpu.eval import auc_parity as jap
import hugectr_backend_tpu_torch.models.dlrm as tdlrm
from hugectr_backend_tpu_torch.eval import auc_parity as tap
from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params


def test_auc_estimator():
    """Rank-based AUC: exact on tiny hand cases, tie-correct, equal to the
    JAX package's."""
    assert tap.auc(np.array([0, 1]), np.array([0.1, 0.9])) == 1.0
    assert tap.auc(np.array([1, 0]), np.array([0.1, 0.9])) == 0.0
    assert tap.auc(np.array([0, 1]), np.array([0.5, 0.5])) == 0.5
    labels = np.array([0, 0, 1, 1, 1])
    scores = np.array([0.1, 0.4, 0.35, 0.8, 0.8])
    assert tap.auc(labels, scores) == pytest.approx(5 / 6)
    rng = np.random.default_rng(0)
    labels = (rng.random(2000) < 0.3).astype(np.float32)
    scores = np.round(rng.standard_normal(2000) + labels, 1)  # many ties
    assert tap.auc(labels, scores) == jap.auc(labels, scores)
    assert np.isnan(tap.auc(np.ones(4), np.arange(4.0)))


def test_datasets_bit_identical():
    got = tap.make_click_dataset(3000, vocab=500, num_feats=8, seed=1)
    want = jap.make_click_dataset(3000, vocab=500, num_feats=8, seed=1)
    for f in ("key_ids", "keys_idx", "dense", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.base_rate == want.base_rate and 0.2 < got.base_rate < 0.8
    got = tap.make_multi_click_dataset(3000, [5, 60, 700], seed=2)
    want = jap.make_multi_click_dataset(3000, [5, 60, 700], seed=2)
    for a, b in zip(got.key_ids, want.key_ids):
        np.testing.assert_array_equal(a, b)
    for f in ("keys_idx", "dense", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.base_rate == want.base_rate


@pytest.fixture(scope="module")
def parity():
    return tap.run_parity(n_train=30_000, n_eval=10_000, vocab=1500, dim=16, num_feats=26,
                          steps=250, seed=1, device="cpu")


def test_int8_auc_parity_north_star(parity):
    assert parity["auc"]["fp32"] > 0.60, parity["auc"]
    assert abs(parity["delta_vs_fp32"]["int8"]) < 1e-3, parity


def test_int4_auc_within_documented_gate(parity):
    assert abs(parity["delta_vs_fp32"]["int4"]) < 1e-2, parity


@pytest.mark.parametrize("name", ["fp8", "int8+dense_int8", "int8+dense_fp8",
                                  "int8+dense_w8a8"])
def test_fp8_and_dense_flavors_measured(parity, name):
    assert abs(parity["delta_vs_fp32"][name]) < 5e-3, (name, parity)


@pytest.fixture(scope="module")
def path_parity():
    return tap.run_path_parity(n_train=12_000, n_eval=5_000, dim=128, steps=150, seed=0,
                               vocabs=[60, 120, 300, 480, 900, 1500, 3000, 5000],
                               device="cpu")


def test_path_parity_int8_mixed_policy(path_parity):
    """int8 through the mixed one-hot / arena / solo grouping, fold off
    (K1 + K2)."""
    assert path_parity["auc"]["fp32"] > 0.55, path_parity["auc"]
    assert abs(path_parity["delta_vs_fp32"]["int8_mixed_policy"]) < 1e-3, path_parity


def test_path_parity_int4(path_parity):
    assert abs(path_parity["delta_vs_fp32"]["int4_mixed_policy"]) < 1e-2, path_parity
    assert "int8_blocked_layout" not in path_parity["auc"]  # flat [R, D] tables only


def test_path_parity_fold(path_parity):
    """The one-hot group folded into the interaction (K3): it ran, and its
    AUC is within the int8 gate."""
    assert path_parity["oh_kernel_engaged"] is True
    assert abs(path_parity["delta_vs_fp32"]["int8_oh_fold"]) < 1e-3, path_parity


@pytest.fixture(scope="module")
def jax_checkpoint():
    data = jap.make_click_dataset(3000, vocab=400, num_feats=8, seed=4)
    n = 2488  # the rest, 512 samples, is held out
    train = jap.ClickDataset(data.key_ids, data.keys_idx[:n], data.dense[:n],
                             data.labels[:n], data.base_rate)
    model, params, table = jap.train_dlrm(train, dim=16, steps=40, batch=256, seed=4)
    return data, n, model, params, table


@pytest.mark.parametrize("quant_bits", [32, 8])
def test_fused_dlrm_server_matches_jax(jax_checkpoint, monkeypatch, quant_bits, tmp_path):
    """A checkpoint trained by the JAX package, served by its
    FusedDlrmServer and by the port's (K1 gathers, K4 interacts)."""
    data, n, fmodel, params, table = jax_checkpoint
    kidx, dense = data.keys_idx[n:], data.dense[n:]
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    want = jap.serving_scores(fmodel, params, data.key_ids, table, kidx, dense,
                              quant_bits=quant_bits, batch=256, workdir=str(tmp_path / "jax"))
    model = DLRM(13, 8, (32, 16), (64, 32, 1))
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    calls = []
    real = tdlrm.fused_dot_interaction
    monkeypatch.setattr(tdlrm, "fused_dot_interaction",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    got = tap.serving_scores(model, data.key_ids, table, kidx, dense, quant_bits=quant_bits,
                             batch=256, device="cpu")
    assert calls == [torch.Size([256, 8, 16])] * 2
    assert got.shape == want.shape == (512,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
