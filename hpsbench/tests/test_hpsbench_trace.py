"""The profiled slice records the host ops of every thread, those started
before it too (the server's handlers and batchers are), and names an idle
gap of the device by what the host was doing in it."""

import threading

import torch
from torch.profiler import record_function

from hpsbench import run, trace
from hpsbench.trace import DeviceOp, HostOp, Slice


def test_slice_holds_ops_of_a_thread_started_before_it():
    stop = threading.Event()
    started = threading.Event()

    def server_thread():
        started.set()
        while not stop.is_set():
            with record_function("hpsbench.probe"):
                torch.ones(8).sum()
            stop.wait(0.002)

    th = threading.Thread(target=server_thread, daemon=True)
    th.start()
    started.wait()
    try:
        rec = trace.record(0.3)
    finally:
        stop.set()
        th.join()
    probes = [h for h in trace.read(rec).host if h.name == "hpsbench.probe"]
    assert probes, sorted({h.name for h in sl.host})[:20]


def _slice():
    # device busy [0, 10], [50, 60] (launched on thread 1), [100, 130]
    # (launched on thread 2), [140, 150] (launcher unknown)
    ops = [DeviceOp("k", 0, 10, 1), DeviceOp("copy", 50, 60, 1), DeviceOp("k", 100, 120, 2),
           DeviceOp("k", 110, 130, 2), DeviceOp("set", 140, 150, None)]
    host = [
        HostOp("batch", 0, 160, 1),            # outermost, covers everything
        HostOp("stage.launch", 10, 55, 1),     # covers the first gap whole
        HostOp("aten::cat", 20, 30, 1),        # inside it, covers less
        HostOp("request", 0, 160, 3),          # a handler waiting throughout
        HostOp("stage.merge", 60, 90, 2),      # most of the second gap
        HostOp("stage.assemble", 90, 100, 2),
        HostOp("stage.split", 130, 141, 7),
    ]
    return Slice(0.0, 1.0, ops, host, 1.0)


def test_idle_gaps_named_by_the_launching_threads_innermost_op():
    sl = _slice()
    assert [b[:2] for b in sl.busy_intervals()] == [[0, 10], [50, 60], [100, 130],
                                                    [140, 150]]
    assert abs(sl.busy_s - 60e-6) < 1e-15
    gaps = sl.breakdown()["idle_gaps"]
    # longest first, in time order where equal: [10, 50] on thread 1, [60,
    # 100] on thread 2, [130, 140] on any thread
    assert gaps == [["stage.launch", 40e-6], ["stage.merge", 40e-6],
                    ["stage.split", 10e-6]]


def test_a_gap_with_no_host_op_on_its_thread():
    # the launching thread 5 ran nothing in [10, 20]: named from every thread
    sl = Slice(0.0, 1.0, [DeviceOp("k", 0, 10, 1), DeviceOp("k", 20, 30, 5)],
               [HostOp("batch", 0, 30, 1), HostOp("http.write", 5, 25, 3),
                HostOp("after", 21, 30, 5)], 1.0)
    assert sl.breakdown()["idle_gaps"] == [["http.write", 10e-6]]
    sl.host = [HostOp("before", 0, 9, 1)]
    assert sl.breakdown()["idle_gaps"] == [["no host op traced", 10e-6]]


def test_host_clock_readers_leave_out_the_profilers_stop():
    """The profiler's stop stalls the server's threads as the slice does; its
    events are read apart from the recording, once the window has closed."""
    rec = trace.record(0.05)
    assert rec.t0 < rec.t1 <= rec.stopped
    ctx = run.Context(*[None] * 10, trace=trace.read(rec), peaks=None)
    assert ctx.untraced == (rec.t0, rec.stopped)
