"""``entry.entry()`` against the JAX package's ``__graft_entry__.entry()``:
the same int8 table bytes, slots and dense inputs, the JAX DLRM params
carried across.

Tolerance: rtol 1e-4 / atol 1e-5 on the logits (tests/test_torch_serving.py's
bar). The JAX side runs with ``HPS_PALLAS_INTERPRET=1`` (the Pallas K4 body:
z rounded to bf16, f32 sums), which the port follows; the two differ in the
order of the f32 sums.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hugectr_backend_tpu_torch.entry import entry
from hugectr_backend_tpu_torch.models import load_flax_dlrm_params
from torch_examples_common import np_tree
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_entry_matches_jax(monkeypatch):
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    jfn, jargs = graft.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = entry(device="cpu", state=load_flax_dlrm_params(np_tree(jargs[0])))
    values, scales, slots, scin, dense = args
    # The same table bytes (50,000 rows and the default row), slots, inputs.
    assert values.dtype == torch.int8 and values.shape == (50_001, 64)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jargs[1]).reshape(values.shape))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jargs[2]))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jargs[3]))
    assert scin is None and jargs[4] is None
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jargs[5]))
    got = fn(*args)
    assert got.shape == want.shape == (128,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_entry_launches_k1_then_k4(monkeypatch):
    """``fn`` is K1 (``gather_dequant``) then the DLRM with K4
    (``fused_dot_interaction``), each once a call."""
    import hugectr_backend_tpu_torch.models.dlrm as tdlrm
    import hugectr_backend_tpu_torch.serving.program as tprog

    calls = []
    for mod, name in ((tprog, "gather_dequant"), (tdlrm, "fused_dot_interaction")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert calls == ["gather_dequant", "fused_dot_interaction"]
    assert torch.isfinite(out).all()
    # Flax's initialisation from a seeded generator: the same weights each time.
    fn2, args2 = entry(device="cpu")
    assert torch.equal(fn2(*args2), out)


def test_entry_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry()
