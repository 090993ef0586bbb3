"""A whole run of each cell on the CPU at a small size, past the look for a
card: ``correct`` comes out true on the program as it is, and false with the
timed path broken underneath it (an answer altered where it is produced,
half of a batch left out), under the cell's closed loop and the generator's
open loop."""

import numpy as np
import pytest
import torch

from hpsbench import run, spec

CELLS = tuple(w["name"] for w in spec._json(spec.ROOT / "BENCHMARK.json")["workloads"])
LOOPS = ("closed", "open")


def small(name, loop="closed"):
    cell = spec.load(name)
    cell.cfg["rows_per_table"] = [min(r, 2000) for r in cell.cfg["rows_per_table"]]
    cell.mix.update(warm_s=0.5, pool=6, keep_bodies=4)
    if loop == "closed":
        cell.mix.update(clients=3)
    else:
        cell.mix.update(loop="open", rate_rps=15.0, connections=4)
    return cell


def run_small(name, seconds=1.5, loop="closed"):
    run.set_cache_dirs()
    return run.run_cell(small(name, loop), 2**31 + 77, seconds, False, "cpu",
                        run.process_start())


def _patch_lookup(monkeypatch, fault):
    from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache

    real = EmbeddingCache.lookup_flat

    def broken(self, keys_per_table, pad_counts=None):
        out = real(self, keys_per_table, pad_counts=pad_counts).clone()
        if fault == "alter":
            out[out.numel() // 3] += 0.5
        else:  # half of the batch left out
            out[out.numel() // 2:] = 0.0
        return out

    monkeypatch.setattr(EmbeddingCache, "lookup_flat", broken)


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, loop):
    out = run_small(name, loop=loop)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in spec.load(name).end_to_end}
    assert {"memory_resident_mb", "setup_s"} <= set(out["metrics"])
    assert out["metrics"]["setup_s"]["value"] > 0
    # the CPU has no card allocator to read: the reading is the card's alone
    assert out["metrics"]["memory_resident_mb"]["value"] == 0


@pytest.mark.parametrize("fault", ("alter", "half"))
@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, loop, fault, monkeypatch):
    _patch_lookup(monkeypatch, fault)
    out = run_small(name, 1.0, loop)
    assert not out["correct"], out["checks"]


def test_traced_run_reports_per_layer_metrics_it_can_read():
    out = run.run_cell(small(CELLS[0]), 5, 1.5, True, "cpu", run.process_start())
    assert out["correct"]
    # on the CPU the histograms are there, the device trace is not
    assert {"merged_batch.b64", "dispatch_ms.b64", "batcher_queue_ms.b64",
            "frontend_ms.b64", "p50_ms.b64", "p95_ms.b64",
            "samples_per_s.b64", "host_pace.b64"} <= set(out["metrics"])
    assert out["metrics"]["samples_per_s.b64"]["value"] > 0
    assert "k1_roofline.b64" not in out["metrics"]
    assert out["device"]["window_s"] > 0


def test_every_answer_judged():
    """The b64 cell's judge compares every answered request by digest, so a
    fault in one lookup in ten still shows."""
    from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache

    real = EmbeddingCache.lookup_flat
    calls = {"n": 0}

    def rare(self, keys_per_table, pad_counts=None):
        out = real(self, keys_per_table, pad_counts=pad_counts)
        calls["n"] += 1
        if calls["n"] % 10 == 0:
            out = out.clone()
            out[-1] = out[-1] + 1.0
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EmbeddingCache, "lookup_flat", rare)
        out = run_small(CELLS[0])
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.card
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(small(CELLS[0]), 3, 2.0, True, "cuda", run.process_start(),
                       run.card_info(1))
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert np.isfinite(out["metrics"]["k1_roofline.b64"]["value"])
