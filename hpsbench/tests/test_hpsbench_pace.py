"""The host-pace probe (``hpsbench/pace.py``): its work is fixed, its pace
follows the clock, the profiled slice is left out of it, and its process
ends with the load generator's."""

import os
import types

import numpy as np
import pytest

from hpsbench import pace, run
from hpsbench.tests.test_hpsbench_imports import loaded
from hpsbench.tests.test_hpsbench_run_cpu import CELLS, run_small


def test_unit_work_does_not_depend_on_the_seed():
    sums = []
    for seed in (1, 2**31 + 77):
        np.random.seed(seed % 2**32)
        work = pace.Work()
        sums.append([work.unit() for _ in range(pace.QUERY_SETS + 1)])
    assert sums[0] == sums[1]


class StepClock:
    """A clock that moves ``step`` seconds each time it is read."""

    def __init__(self, step):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_half_speed_clock_halves_the_pace_and_keeps_the_paced_rate():
    work = pace.Work()
    full = pace.pace([pace.burst(work, clock=StepClock(0.010)) for _ in range(3)])
    half = pace.pace([pace.burst(work, clock=StepClock(0.020)) for _ in range(3)])
    assert full == pytest.approx(pace.UNITS / 0.010)
    assert half == pytest.approx(full / 2)
    rate = 24_000.0
    assert pace.paced(rate / 2, half) == pytest.approx(pace.paced(rate, full))
    assert pace.paced(rate, pace.P_REF) == pytest.approx(rate)


def test_bursts_inside_the_profiled_slice_are_left_out():
    bursts = [[t, t + 0.02, 0.02] for t in (10.0, 10.25, 11.99, 12.5, 13.0, 13.5, 14.2)]
    # profiled 12.0-13.1 s, the profiler stopped at 13.2 s
    w = types.SimpleNamespace(
        results=types.SimpleNamespace(t0=10.1), slice=types.SimpleNamespace(t0=12.0, stopped=13.2),
        probe={"bursts": bursts, "cpu": []}, host={})
    out = run.pace_readings(w, 8.0)["probe"]
    assert out["n"] == 3  # 10.25, 13.5 and 14.2; 10.0 is before the window
    assert pace.bursts_in(bursts, 10.1, 18.1, (12.0, 13.2)) == [bursts[i] for i in (1, 5, 6)]
    assert len(pace.bursts_in(bursts, 10.1, 18.1)) == 6


def _children():
    me, kids = os.getpid(), set()
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            if ppid == me:
                kids.add(int(d))
    return kids


def test_probe_process_ends_with_the_load_generator(capsys):
    before = _children()
    run_small(CELLS[0])
    assert "host pace: " in capsys.readouterr().err
    assert _children() <= before


def test_probe_process_ends_when_the_window_fails(monkeypatch):
    real, calls = run._readline, {"n": 0}

    def failing(proc, timeout):
        calls["n"] += 1
        if calls["n"] == 3:  # the load generator's "done"
            raise run.Failure("the load generator did not finish")
        return real(proc, timeout)

    monkeypatch.setattr(run, "_readline", failing)
    before = _children()
    with pytest.raises(run.Failure):
        run_small(CELLS[0])
    assert _children() <= before


def test_probe_loads_numpy_and_the_standard_library_only():
    mods = loaded("hpsbench.pace")
    assert not mods & {"torch", "jax", "jaxlib", "flax", "hugectr_backend_tpu",
                       "hugectr_backend_tpu_torch"}
