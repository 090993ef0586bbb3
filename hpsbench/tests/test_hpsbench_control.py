"""The control of each cell comes out as not correct: the reference at the
precision below the configuration's, put in the program's place."""

import pytest

from hpsbench import readings, run
from hpsbench.tests.test_hpsbench_run_cpu import CELLS, small


@pytest.mark.parametrize("name", CELLS)
def test_int4_rows_fail_the_exact_comparison(name):
    cell = small(name)
    run.set_cache_dirs()
    out = readings.reading(cell, 2**31 + 3, 1.0, "cpu", control=True)
    assert out["program"]["wrong_answers"] == 0 and out["program"]["max_abs_gap"] == 0.0
    assert out["control"]["wrong_answers"] == out["answered"] > 0
    assert out["control"]["max_abs_gap"] > cell.limits["max_abs_gap"]

