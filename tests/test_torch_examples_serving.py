"""Examples 01 and 04 of the port against the JAX package's: the same
ps.json served over KServe-v2 HTTP by both, and the responses compared.

Tolerance: none. Both packages quantize the same rows the same way and
dequantize with one f32 multiply, so the HTTP outputs are bit-identical.
"""

import numpy as np
import pytest

from torch_examples_common import port_example, run_jax_example
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_01_deploy_and_lookup_matches_jax(tmp_path):
    want = run_jax_example("01_deploy_and_lookup")
    got = port_example("01_deploy_and_lookup").main(device="cpu", root=tmp_path)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    assert got["ready"] == 200
    assert got["num_sample"] == want["resp"]["parameters"]["NumSample"] == 2
    assert got["output"].dtype == want["out"].dtype == np.float32
    np.testing.assert_array_equal(got["output"], want["out"])


@pytest.mark.parametrize("shards", [8, 2])
def test_04_sharded_multichip_matches_jax(tmp_path, shards):
    """The JAX example shards over the test harness's 8 virtual devices; the
    port's over ``shards`` entries on the host. The answer does not depend on
    the shard count."""
    want = run_jax_example("04_sharded_multichip")
    assert want["n_dev"] == 8
    got = port_example("04_sharded_multichip").main(device="cpu", root=tmp_path, shards=shards)
    assert got["strategy"] == want["cache"].strategy == "all_to_all"
    assert got["shared_device"]
    np.testing.assert_array_equal(got["keys"], want["q"])
    np.testing.assert_array_equal(got["output"], want["out"])
    assert got["max_err"] == float(want["err"])
    if shards == 8:
        assert got["per_shard_mb"] == pytest.approx(want["per_shard"], rel=1e-12)


def test_04_placement_needs_a_card_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    mod = port_example("04_sharded_multichip")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.placement(None, 8)
    assert mod.placement("cpu", 8) == ("cpu", True)
    assert mod.placement("cpu", 1) == ("cpu", False)
