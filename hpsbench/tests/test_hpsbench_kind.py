"""A kind that exists only as new files (``kind_fixture.py``, registered for
these tests alone) runs through ``run.run_cell`` on the CPU: seed-drawn
weights written beside the tables, per-sample dense features, multi-hot bags
and drawn request sizes. It is judged correct, and not correct where its
judge draws the weights from another seed."""

import copy
import dataclasses
import sys

import pytest

from hpsbench import run, spec
from hpsbench.tests import kind_fixture as fx

SEED = 2**31 + 91


@pytest.fixture
def cell(monkeypatch):
    monkeypatch.setitem(sys.modules, f"hpsbench.deploy.{fx.KIND}", fx)
    bench = spec._json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell("test-dense-buckets.closed", 1, copy.deepcopy(fx.CONFIG),
                     copy.deepcopy(fx.MIX), dict(fx.LIMITS), bench["end_to_end"], [])


def run_judged(cell, monkeypatch, seconds=1.5):
    """One CPU run of ``cell``; -> (result, the judge's context)."""
    seen = []
    real = fx.judge

    def judge(ctx, control=None):
        seen.append(ctx)
        return real(ctx, control)

    monkeypatch.setattr(fx, "judge", judge)
    run.set_cache_dirs()
    out = run.run_cell(cell, SEED, seconds, False, "cpu", run.process_start())
    return out, seen[0]


def test_the_kind_is_no_benchmark_entry():
    bench = spec._json(spec.ROOT / "BENCHMARK.json")
    kinds = {spec._json(spec.ROOT / c["file"])["kind"] for c in bench["configs"]}
    assert fx.KIND not in kinds


@pytest.mark.parametrize("loop", ("closed", "open"))
def test_new_kind_runs_and_is_judged_correct(cell, loop, monkeypatch):
    if loop == "open":
        cell.mix.update(loop="open", rate_rps=15.0, connections=4)
    out, ctx = run_judged(cell, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["wrong_answers"]["value"] == 0
    assert ctx.seed == SEED
    sizes = {r.samples for r in ctx.requests}
    assert sizes <= {3, 10, 17} and len(sizes) > 1
    for r in ctx.requests:
        assert r.dense.shape == (r.samples, 3)
        assert [k.size for k in r.keys] == [r.samples * k for k in (1, 3, 2, 5)]


def test_judged_with_another_seeds_weights_is_not_correct(cell, monkeypatch):
    real = run.judge
    monkeypatch.setattr(run, "judge", lambda ctx, control=None: real(
        dataclasses.replace(ctx, seed=ctx.seed + 1), control))
    out, ctx = run_judged(cell, monkeypatch, 1.0)
    assert ctx.seed == SEED + 1
    assert not out["correct"], out["checks"]
    assert out["checks"]["wrong_answers"]["value"] > 0
