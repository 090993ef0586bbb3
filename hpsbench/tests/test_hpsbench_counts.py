"""The bytes that the K1 roofline reader counts, on hand-worked shapes; the
host-clock readers leave out the profiled slice."""

import types

import numpy as np

from hpsbench.metrics import frontend_ms, k1_roofline, p50_ms, p95_ms
from hpsbench.run import Results
from hpsbench.traffic import Request

CFG = {"embedding_dim": 128}
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def test_k1_bytes_distinct_rows_and_default_row():
    # table 0: rows 5, 5, 7 -> 2 distinct; table 1: rows 1, -1, -1 -> row 1 and
    # the default row; 6 keys out of 512 bytes each
    req = Request(3, [np.array([5, 5, 7]), np.array([1, -1, -1])], [None, None])
    assert k1_roofline.request_bytes(req, 128) == 4 * 132 + 6 * 512


def _results(sent, done, ok=None):
    res = Results.__new__(Results)
    res.sent = res.due = np.asarray(sent, float)
    res.done = np.asarray(done, float)
    res.ok = np.ones(res.done.size, bool) if ok is None else np.asarray(ok)
    res.entry = np.zeros(res.done.size, np.int64)
    res.attempted = res.done.size
    return res


def _ctx(ops, res, trace=True):
    req = Request(4, [np.arange(4) % 3, np.array([0, -1, 2, 2])], [None, None])
    tr = types.SimpleNamespace(ops=ops, t0=1.0, t1=2.0) if trace else None
    ctx = types.SimpleNamespace(cfg=CFG, peaks=PEAKS, results=res, requests=[req],
                                trace=tr, untraced=(1.0, 2.0) if trace else None,
                                hist={"hps_inference_request_duration_seconds": (4, 0.2)})
    ctx.answered_in = lambda a, b: np.flatnonzero(res.ok & (res.done >= a) & (res.done <= b))
    return ctx


def op(name, us):
    return types.SimpleNamespace(name=name, start_us=0.0, end_us=us, host_ops=())


def test_k1_reader_on_a_hand_worked_slice():
    ops = [op("void grouped_gather_kernel<8>(Params<8>)", 40.0),
           op("Memcpy DtoH (Device -> Pageable)", 30.0)]
    # answered in the slice [1, 2]: the second and third
    ctx = _ctx(ops, _results([0.1, 1.2, 1.5, 2.5], [0.5, 1.4, 1.9, 2.7]))
    nbytes = k1_roofline.request_bytes(ctx.requests[0], 128)
    assert abs(k1_roofline.read(ctx) - 100 * 2 * nbytes / 3.35e12 / 40e-6) < 1e-9


def test_readers_find_nothing():
    ctx = _ctx([op("Memcpy HtoD", 5.0)], _results([0.1], [1.5]))
    assert k1_roofline.read(ctx) is None
    ctx.trace = None
    assert k1_roofline.read(ctx) is None


def test_latency_readers_leave_out_the_slice():
    # open in [1, 2]: the second (sent before, answered inside), the third
    # (inside), the fourth (spans it); the first and last are read
    res = _results([0.0, 0.9, 1.2, 0.5, 2.1], [0.01, 1.1, 1.3, 2.5, 2.15])
    ctx = _ctx([], res)
    assert res.overlaps(1.0, 2.0).tolist() == [False, True, True, True, False]
    assert abs(p50_ms.read(ctx) - 10.0) < 1e-9 and abs(p95_ms.read(ctx) - 50.0) < 1e-9
    # client mean 30 ms of the two read, less the program's 50 ms mean
    assert abs(frontend_ms.read(ctx) - (30.0 - 50.0)) < 1e-9
    untraced = _ctx([], res, trace=False)
    assert abs(p95_ms.read(untraced) - 1000 * (2.5 - 0.5)) < 1e-9


def test_latency_reader_counts_failures_as_slowest():
    res = _results([0.0, 0.1, 0.2], [0.01, 0.11, 0.5], ok=[True, True, False])
    assert p95_ms.read(_ctx([], res, trace=False)) == float("inf")
