"""The readers of the program's stage spans and K1's launch counter: the
window's mean of their histograms, in ms (launches a batch for K1), and
nothing where the program has no such histogram, as before these spans."""

import types

import pytest

from hpsbench.metrics import (
    assemble_ms,
    copy_back_ms,
    http_read_ms,
    http_write_ms,
    k1_launches,
    launch_ms,
    lock_wait_ms,
    translate_ms,
)

READERS = [
    (http_read_ms, "hps_http_read_seconds", 1e3),
    (http_write_ms, "hps_http_write_seconds", 1e3),
    (lock_wait_ms, "hps_dispatch_lock_wait_seconds", 1e3),
    (translate_ms, "hps_dispatch_translate_seconds", 1e3),
    (assemble_ms, "hps_dispatch_assemble_seconds", 1e3),
    (launch_ms, "hps_dispatch_launch_seconds", 1e3),
    (copy_back_ms, "hps_dispatch_copy_back_seconds", 1e3),
    (k1_launches, "hps_k1_launches_per_batch", 1.0),
]


@pytest.mark.parametrize("mod,hist,scale", READERS)
def test_reader_takes_the_window_mean(mod, hist, scale):
    # 4 observations summing to 0.02 (s, or launches), beside another
    # histogram that the reader must not read
    ctx = types.SimpleNamespace(hist={hist: (4, 0.02), "hps_other": (1, 9.0)})
    assert mod.read(ctx) == pytest.approx(0.005 * scale, rel=1e-12)


@pytest.mark.parametrize("mod,hist,scale", READERS)
def test_reader_finds_nothing_without_the_histogram(mod, hist, scale):
    assert mod.read(types.SimpleNamespace(hist={})) is None
    assert mod.read(types.SimpleNamespace(hist={hist: (0, 0.0)})) is None
