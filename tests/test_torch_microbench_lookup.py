"""The port's ``microbench_int4_gather`` and ``microbench_overhead`` against
the JAX package's scripts (imported by path): the tables, the slots, and
the gathered rows (K1's plain version) against the JAX package's gathers on
the same tables, bit for bit. On the CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hugectr_backend_tpu.tiers.hbm import gather_dequant_xla
from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant
from hugectr_backend_tpu_torch.scripts import microbench_int4_gather as mg
from hugectr_backend_tpu_torch.scripts import microbench_overhead as mo

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent
ROWS, BATCH = 5000, 64


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_int4():
    return _load("microbench_int4_gather")


@pytest.fixture(scope="module")
def jax_overhead():
    return _load("microbench_overhead")


def test_int4_tables_and_slots_match_the_jax_script(jax_int4, monkeypatch):
    monkeypatch.setattr(jax_int4, "ROWS", ROWS)
    monkeypatch.setattr(jax_int4, "BATCH", BATCH)
    j8, j4 = jax_int4.gen_tables()
    q8, q4 = mg.gen_tables(ROWS, "cpu")
    np.testing.assert_array_equal(q8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(q4.numpy(), np.asarray(j4))
    assert (mg.DIM, mg.BATCH, mg.ROWS) == (jax_int4.DIM, 4096, 2_000_000)
    for seed in (1, 2):
        np.testing.assert_array_equal(mg.slots_for(seed, BATCH, ROWS),
                                      np.asarray(jax_int4.slots_for(seed)))


def test_int4_and_int8_rows_match_jax(one_torch_thread):
    q8, q4 = mg.gen_tables(ROWS, "cpu")
    sl = mg.slots_for(3, BATCH, ROWS)
    scin = np.full(BATCH, mg.SCALE, np.float32)
    for bits, t in ((8, q8), (4, q4)):
        got = gather_dequant(t, None, torch.from_numpy(sl), torch.from_numpy(scin)).numpy()
        want = np.asarray(gather_dequant_xla(jnp.asarray(t.numpy()), None, jnp.asarray(sl))
                          * jnp.asarray(scin)[:, None])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, mg.truth(sl, bits))


def test_int4_run_checks_itself_on_the_cpu(one_torch_thread):
    lines = mg.run("cpu", batch=BATCH, rows=ROWS, emit=lambda line: None)
    assert [ln["row_bytes"] for ln in lines] == [128, 64]


def test_overhead_configs_and_rows_match_the_jax_script(jax_overhead, one_torch_thread):
    """The JAX script's configurations (microbench_overhead.py:55), and one
    iteration's rows against its ``take`` formulation on the same table."""
    assert mo.CONFIGS == ((16_384, 4096), (16_384, 1024), (1_048_576, 4096))
    assert mo.ITERS == (16, 64, 256)
    ch = mo.Chain(ROWS, BATCH, "cpu")
    v, s = jnp.asarray(ch.values.numpy()), jnp.asarray(ch.scales.numpy())
    sl = jnp.asarray(ch.host)
    want = np.asarray(jnp.take(v, sl, axis=0).astype(jnp.float32)
                      * jnp.take(s, sl, axis=0)[:, None])
    got = ch.step().numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(ch.slots.numpy(), ch.host)  # the bump moved the slots
    rel = ch.slots.numpy()
    assert ((rel >= 0) & (rel < ROWS)).all()


def test_overhead_fit_and_run_on_the_cpu(one_torch_thread):
    assert mo.fit((16, 64, 256), (16 * 3 + 10, 64 * 3 + 10, 256 * 3 + 10)) == pytest.approx(
        (3.0, 10.0))
    lines = mo.run("cpu", configs=((ROWS, BATCH),), emit=lambda line: None)
    assert lines[0]["probe"] and lines[1]["check"] == "bit-exact vs the closed form"
