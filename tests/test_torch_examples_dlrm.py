"""Examples 02 and 05 of the port against the JAX package's, on the same
tables, keys and weights (the JAX example's Flax params and torch MLP
carried across).

Tolerances:
- 02's logits: rtol 1e-4 / atol 1e-5, the bar of tests/test_torch_serving.py.
  The JAX side runs with ``HPS_PALLAS_INTERPRET=1`` (the Pallas interaction
  bodies: z rounded to bf16, f32 sums), as the port computes on every path;
  the two differ in the order of the f32 sums.
- 05's converted dense model: the JSON bytes and every array bit-identical;
  the ensemble's predictions rtol 1e-5 / atol 1e-6 (f32 layers, sums in
  another order), and each side within the example's own rtol 1e-4 / atol
  1e-5 of the torch MLP.
"""

import json

import numpy as np
import pytest
import torch

from hugectr_backend_tpu_torch.models import load_flax_dlrm_params
from torch_examples_common import np_tree, port_example, run_jax_example
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_02_fused_dlrm_serving_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    want = run_jax_example("02_fused_dlrm_serving")
    want_multi = np.asarray(want["srv2"].predict(want["keys2"], want["dense"]))
    state = {"dlrm": load_flax_dlrm_params(np_tree(want["params"])),
             "dlrm_multi": load_flax_dlrm_params(np_tree(want["params2"]))}
    got = port_example("02_fused_dlrm_serving").main(device="cpu", root=tmp_path, state=state)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["dense"], want["dense"])
    for a, b in zip(got["multi_keys"], want["keys2"]):
        np.testing.assert_array_equal(a, b)
    assert got["logits"].shape == got["multi_logits"].shape == (32,)
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["multi_logits"], want_multi, rtol=1e-4, atol=1e-5)


def test_02_default_weights_are_flax_init_from_a_seed(tmp_path):
    """Without ``state`` the two DLRMs take Flax's initialisation from
    seeded generators: two runs agree bit for bit."""
    mod = port_example("02_fused_dlrm_serving")
    a = mod.main(device="cpu", root=tmp_path / "a")
    b = mod.main(device="cpu", root=tmp_path / "b")
    np.testing.assert_array_equal(a["logits"], b["logits"])
    np.testing.assert_array_equal(a["multi_logits"], b["multi_logits"])


def _arrays(npz_path):
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}


def test_05_triton_repo_ensemble_matches_jax(tmp_path):
    want = run_jax_example("05_triton_repo_ensemble")
    mlp = want["mlp"]
    got = port_example("05_triton_repo_ensemble").main(
        device="cpu", root=tmp_path, state={"mlp": mlp.state_dict()})
    np.testing.assert_array_equal(got["keys"], want["keys"])
    # The two converters' files.
    jdir, tdir = want["ddir"] / "1", tmp_path / "dense_model" / "1"
    assert (tdir / "dense_model.json").read_bytes() == (jdir / "dense_model.json").read_bytes()
    assert json.loads((tdir / "dense_model.json").read_text())["reshape"] == [-1, 64]
    ja, ta = _arrays(jdir / "dense_model.npz"), _arrays(tdir / "dense_model.npz")
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    # The ensembles' predictions.
    assert got["output"].shape == (3, 1)
    np.testing.assert_allclose(got["output"], want["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["torch_output"], want["want"], rtol=0, atol=0)
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(want["x"]))
        np.testing.assert_array_equal(mlp(x).numpy(), got["torch_output"])
