"""Examples 07 and 09 of the port against the JAX package's, on the same
tables and keys, with the Flax params of every model carried across.

Tolerances:
- 07's logits: rtol 1e-4 / atol 1e-5, the bar of tests/test_torch_zoo.py
  (f32 on both sides, sums in another order; the JAX side runs its Pallas
  bodies in interpret mode, ``HPS_PALLAS_INTERPRET=1``).
- 09: the retrieved keys equal, position by position; scores rel < 1e-6.
"""

import numpy as np
import pytest

import hugectr_backend_tpu.serving.pooled as jpooled
import hugectr_backend_tpu.serving.program as jprog
from hugectr_backend_tpu_torch import models as tmodels
from torch_examples_common import np_tree, port_example, run_jax_example
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX example's server factories, in its order, and the port's names.
FACTORIES = (("make_wdl_server", "WDL", "wdl", tmodels.load_flax_wdl_params),
             ("make_deepfm_server", "DeepFM", "deepfm", tmodels.load_flax_deepfm_params),
             ("make_dcn_server", "DCN-v2", "dcn_v2", tmodels.load_flax_dcn_params),
             ("make_xdeepfm_server", "xDeepFM", "xdeepfm", tmodels.load_flax_xdeepfm_params),
             ("make_ncf_server", "NCF", "ncf", tmodels.load_flax_ncf_params))


def test_07_model_zoo_matches_jax(tmp_path, monkeypatch):
    """Each JAX server the example builds is recorded with its Flax params
    and its predict's output."""
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    seen = {}

    def recording(label, make):
        def factory(params, cache, model, model_params):
            srv = make(params, cache, model, model_params)
            real = srv.predict

            def predict(*a, **kw):
                out = real(*a, **kw)
                seen[label] = (model_params, np.asarray(out))
                return out

            srv.predict = predict
            return srv

        return factory

    for fn, label, _, _ in FACTORIES:
        monkeypatch.setattr(jprog, fn, recording(label, getattr(jprog, fn)))

    class RecordingDin(jpooled.FusedDinServer):
        def __init__(self, params, cache, model, model_params, **kw):
            super().__init__(params, cache, model, model_params, **kw)
            self._flax_params = model_params

        def predict(self, *a, **kw):
            out = super().predict(*a, **kw)
            seen["BST"] = (self._flax_params, np.asarray(out))
            return out

    monkeypatch.setattr(jpooled, "FusedDinServer", RecordingDin)
    run_jax_example("07_model_zoo")
    assert list(seen) == [label for _, label, _, _ in FACTORIES] + ["BST"]

    state = {name: load(np_tree(seen[label][0])) for _, label, name, load in FACTORIES}
    state["bst"] = tmodels.load_flax_bst_params(np_tree(seen["BST"][0]))
    got = port_example("07_model_zoo").main(device="cpu", root=tmp_path, state=state)
    assert list(got) == list(seen)
    for label, (_, want) in seen.items():
        assert got[label].shape == want.shape == (8,), label
        np.testing.assert_allclose(got[label], want, rtol=1e-4, atol=1e-5, err_msg=label)


def test_09_retrieval_topk_matches_jax(tmp_path):
    want = run_jax_example("09_retrieval_topk")
    state = {"two_tower": tmodels.load_flax_two_tower_params(np_tree(want["params"]))}
    got = port_example("09_retrieval_topk").main(device="cpu", root=tmp_path, state=state)
    np.testing.assert_array_equal(got["user_keys"], want["ukeys"])
    np.testing.assert_array_equal(got["dense"], want["dense"])
    assert got["item_keys"].shape == got["scores"].shape == (8, 10)
    np.testing.assert_array_equal(got["item_keys"], np.asarray(want["item_keys"]))
    jscores = np.asarray(want["scores"])
    rel = np.abs(got["scores"] - jscores).max() / np.abs(jscores).max()
    assert rel < 1e-6, rel


@pytest.mark.parametrize("name", ["07_model_zoo", "09_retrieval_topk"])
def test_default_weights_are_flax_init_from_a_seed(tmp_path, name):
    """Without ``state`` every model takes Flax's initialisation from a
    seeded generator: two runs agree bit for bit."""
    mod = port_example(name)
    a = mod.main(device="cpu", root=tmp_path / "a")
    b = mod.main(device="cpu", root=tmp_path / "b")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
