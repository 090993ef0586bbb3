"""chip_smoke.py's "examples" phase, rehearsed on the CPU: the checks it
makes of each example's card run against its CPU run, and the phase itself
at smoke size on two examples (on the CPU no kernel launches, and the plain
versions serve)."""

import numpy as np
import pytest
import torch

import chip_smoke

from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_examples_phase_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PERF_CLIENT_ROWS", 4096)
    monkeypatch.setattr(chip_smoke, "FRONTEND_CLIENTS", 2)
    fe = {"qps": 200.0, "p50_ms": 35.0, "p99_ms": 50.0, "mean_merged_batch": 160.0}
    lines = []
    res = chip_smoke.examples_phase(torch.device("cpu"), fe, emit_line=lines.append,
                                    names=("01_deploy_and_lookup", "09_retrieval_topk"),
                                    smoke=True)
    assert not any(res["launches"].values())
    examples = [ln["example"] for ln in lines if "example" in ln]
    assert examples == ["entry", "01_deploy_and_lookup", "09_retrieval_topk"]
    (perf,) = [ln["perf_client"] for ln in lines if "perf_client" in ln]
    assert perf["requests_ok"] > 0 and perf["requests_err"] == 0
    (sat,) = [ln["frontend_saturation"] for ln in lines if "frontend_saturation" in ln]
    assert "stubbed" in sat["device"] and sat["concurrency_scan"] == [2]
    (auc,) = [ln["auc_parity_smoke"] for ln in lines if "auc_parity_smoke" in ln]
    assert all(auc["gates"].values())


def test_expected_launches_name_every_kernel_of_an_example():
    exp = chip_smoke.ex_expected_launches
    assert exp("02_fused_dlrm_serving", {}) == {
        "gather_dequant": 2, "fused_dot_interaction": 1,
        ("dot_interaction_parts", "dot_interaction_oh_parts"): 1}
    assert exp("03_online_updates", {"lookups": 5}) == {"gather_dequant": 5}
    assert exp("08_kafka_groups_compression", {}) == {}
    cuda = torch.device("cuda", 0)
    chip_smoke.ex_check_launches("02", {"gather_dequant": 2, "fused_dot_interaction": 1,
                                        "dot_interaction_oh_parts": 1},
                                 exp("02_fused_dlrm_serving", {}), cuda)
    for bad in ({"gather_dequant": 3, "fused_dot_interaction": 1, "dot_interaction_parts": 1},
                {"gather_dequant": 2, "fused_dot_interaction": 1},
                {"gather_dequant": 2, "fused_dot_interaction": 1, "dot_interaction_parts": 1,
                 "w8a8_dense": 4}):
        with pytest.raises(AssertionError):
            chip_smoke.ex_check_launches("02", bad, exp("02_fused_dlrm_serving", {}), cuda)
    with pytest.raises(AssertionError, match="on the CPU"):
        chip_smoke.ex_check_launches("01", {"gather_dequant": 1}, {}, torch.device("cpu"))


def test_card_vs_cpu_comparisons_catch_a_difference():
    want = np.array([10.0, -0.5, 1e-3], np.float32)
    assert chip_smoke.ex_close("x", want + np.float32(1e-6), want, (1e-4, 1e-5)) > 0
    with pytest.raises(AssertionError, match="past rtol"):
        chip_smoke.ex_close("x", want + np.float32(2e-3), want, (1e-4, 1e-5))
    with pytest.raises(AssertionError):
        chip_smoke.ex_same("x", want + np.float32(1e-6), want)
    with pytest.raises(AssertionError):
        chip_smoke.ex_same("x", want.astype(np.float64), want)
    # Retrieval: a tie may come in another order; a separated key may not.
    scores = np.array([[0.9, 0.8, 0.8, 0.5, 0.4]], np.float32)
    keys = np.array([[1, 2, 3, 4, 5]])
    want = {"scores": scores, "item_keys": keys}
    r = chip_smoke.ex_retrieval({"scores": scores, "item_keys": keys[:, [0, 2, 1, 3, 4]]}, want)
    assert r["keys_compared"] == 2  # positions 0 and 3; the tie and the last are not
    with pytest.raises(AssertionError, match="separated"):
        chip_smoke.ex_retrieval({"scores": scores, "item_keys": keys[:, [0, 1, 2, 4, 3]]},
                                want)
    with pytest.raises(AssertionError, match="scores rel"):
        chip_smoke.ex_retrieval({"scores": scores * 1.01, "item_keys": keys}, want)
