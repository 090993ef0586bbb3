"""Spans over the serving path: the reference's NVTX ranges, over ``torch.profiler``.

The reference wraps its hot sections in NVTX ranges (``NVTX_RANGE(nvtx_,
"ModelInstanceExecute...")``, reference hps_backend/src/hps.cc:375,671-675).
Here one primitive, :class:`span`, marks each stage of a request and of a
merged batch, and does up to three things:

- always, it times its interval, and observes the interval (seconds) on a
  histogram of ``serving/metrics.py`` where it has one, under the ``model``
  label alone (inside :func:`held`, once the held block succeeds);
- while any ``torch.profiler`` records in the process, it opens a
  ``record_function`` range of its name: the span then sits on the
  profiler's timeline, on its own thread's row, on the clock of the card's
  kernels and copies (and as an NVTX range under
  ``torch.autograd.profiler.emit_nvtx()``);
- while :func:`start_trace` records, it appends an entry to the span log:
  its name, the ids its thread carries (a request id on a front-end
  thread, a batch id and its request ids on a batcher thread), its parent
  span on the same thread, the thread's native id (the profiler's ``tid``)
  and its start and end on CLOCK_MONOTONIC. The log, not the range, carries
  the ids: ``record_function``'s ``args`` do not reach the exported Chrome
  trace, and a request's wait in the queue spans no thread.

``HPS_TPU_DISABLE_TRACING`` ("1", "true", "yes" or "on", read whenever a
profiler or the log records) turns the ranges and the log off; it never
turns off a histogram. With nothing recording, a span costs two clock reads
and a flag read (and its histogram's observe).

``start_trace`` / ``stop_trace`` record a ``torch.profiler`` trace of every
thread (host activity, and the card's where there is one) and write it
into a directory as a Chrome trace, with the span log beside it as a second
Chrome trace on the same clock; Perfetto opens the two together.

    with span("hps.dispatch.copy_back", metrics.DISPATCH_COPY_BACK_SECONDS, model):
        ...
    start_trace("/tmp/hps_trace")
    ...
    stop_trace()   # -> /tmp/hps_trace/hps_trace_<pid>_<n>.json
                   #  + /tmp/hps_trace/hps_spans_<pid>_<n>.json
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

from torch.autograd import profiler as _autograd_profiler

#: Entries the span log keeps for one trace (some 100 s of a server busy
#: with 350 requests a second); past it, spans are counted as dropped.
LOG_CAP = 1 << 18
#: Name of the ranges that ``start_trace`` stamps to align the log's clock.
CLOCK_RANGE = "hps.trace.clock"

_lock = threading.Lock()
_active = None  # _Trace between start_trace and stop_trace
_log = None     # its _Log while spans are logged
_count = 0
_ids = itertools.count(1)   # request and batch ids, one sequence
_seqs = itertools.count(1)  # logged spans


def _tracing_disabled() -> bool:
    # Read per call, so that the switch works when set after import; "0" and
    # "false" leave tracing on, as every other switch of the package reads.
    return os.environ.get("HPS_TPU_DISABLE_TRACING", "").strip().lower() in (
        "1", "true", "yes", "on")


class _Thread(threading.local):
    """What spans need of their thread: its native id, the logged spans open
    on it (seq, name), the ids its spans carry, and the histogram
    observations that :func:`held` holds back."""

    def __init__(self):
        self.tid = threading.get_native_id()
        self.stack = []
        self.ids = {}
        self.held = None


_thread = _Thread()


class _Log:
    """One trace's span entries: (name, ids, seq, parent, tid, t0_ns, t1_ns);
    ``parent`` is the enclosing logged span's (seq, name) on the same thread,
    ``tid`` None for an interval logged without a thread."""

    def __init__(self):
        self.entries = []
        self.dropped = 0
        self._drop_lock = threading.Lock()

    def add(self, entry) -> None:
        if len(self.entries) < LOG_CAP:
            self.entries.append(entry)
        else:
            with self._drop_lock:
                self.dropped += 1


def new_id() -> int:
    """A fresh request or batch id (one sequence for both)."""
    return next(_ids)


def current_request():
    """The request id that the calling thread's spans carry, or None."""
    return _thread.ids.get("request")


class span:
    """Context manager: one stage of the serving path (module docstring).

    ``hist`` (a ``metrics.Histogram``) observes the span's seconds under
    ``model=model`` when its block ends without an exception (inside
    :func:`held`, when the held block does too). ``ids``
    (``request=``, ``batch=``, ``requests=``) become the ids that this span
    and every span inside it on the same thread carry. After the span,
    ``t0`` and ``t1`` hold its start and end (``time.perf_counter_ns``,
    CLOCK_MONOTONIC on Linux)."""

    __slots__ = ("name", "hist", "model", "ids", "t0", "t1", "_range", "_log", "_seq",
                 "_outer_ids")

    def __init__(self, name: str, hist=None, model: str = "", **ids):
        self.name, self.hist, self.model, self.ids = name, hist, model, ids
        self._range = self._log = None

    def __enter__(self):
        if self.ids:
            self._outer_ids, _thread.ids = _thread.ids, self.ids
        log = _log
        if ((log is not None or _autograd_profiler._is_profiler_enabled)
                and not _tracing_disabled()):
            if _autograd_profiler._is_profiler_enabled:
                import torch.profiler

                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            if log is not None:
                self._log, self._seq = log, next(_seqs)
                _thread.stack.append((self._seq, self.name))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.hist is not None and exc[0] is None:
            seconds = (self.t1 - self.t0) * 1e-9
            if _thread.held is None:
                self.hist.observe(seconds, model=self.model)
            else:
                _thread.held.append((self.hist, seconds, self.model))
        if self._log is not None:
            stack = _thread.stack
            stack.pop()
            self._log.add((self.name, _thread.ids, self._seq, stack[-1] if stack else None,
                           _thread.tid, self.t0, self.t1))
            self._log = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.ids:
            _thread.ids = self._outer_ids
        return False


@contextlib.contextmanager
def held():
    """Hold back the histogram observations of the calling thread's spans
    until the block ends; make them if it ends without an exception, drop
    them if not. A merged batch that fails is retried request by request,
    and only the attempts that answer count, every stage or none."""
    _thread.held = mine = []
    try:
        yield
    finally:
        _thread.held = None
    for hist, seconds, model in mine:
        hist.observe(seconds, model=model)


def annotate(name: str) -> span:
    """Context manager marking a host-side region in profiler traces: a
    :class:`span` without a histogram."""
    return span(name)


def log_interval(name: str, t0_s: float, t1_s: float, **ids) -> None:
    """Append an interval that no thread spans (``time.perf_counter``
    seconds, e.g. a request's wait in a queue) to the span log, while
    :func:`start_trace` records."""
    log = _log
    if log is not None and not _tracing_disabled():
        log.add((name, ids, next(_seqs), None, None, int(t0_s * 1e9), int(t1_s * 1e9)))


class _Trace:
    def __init__(self, prof, log_dir: str, log):
        self.prof, self.log_dir, self.log = prof, log_dir, log
        self.clock = []  # (perf_counter_ns before, after) of each CLOCK_RANGE


def start_trace(log_dir: str) -> None:
    """Start recording a ``torch.profiler`` trace of every thread of the
    process (CPU activity, and CUDA activity when a card is present) and
    the span log, which :func:`stop_trace` writes into ``log_dir``. Raises
    if a trace is already being recorded."""
    global _active, _log
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    with _lock:
        if _active is not None:
            raise RuntimeError(f"a trace into {_active.log_dir!r} is already being recorded")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # Every thread: the front end's handlers and the batcher's workers
        # were running before the profiler started.
        prof = profile(activities=activities,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
        trace = _Trace(prof, log_dir, None if _tracing_disabled() else _Log())
        if trace.log is not None:
            # Stamp a few ranges on both clocks; stop_trace aligns the log
            # by the narrowest.
            for _ in range(3):
                a = time.perf_counter_ns()
                with record_function(CLOCK_RANGE):
                    pass
                trace.clock.append((a, time.perf_counter_ns()))
        _active, _log = trace, trace.log


def stop_trace() -> str:
    """Stop the trace that :func:`start_trace` began and write it into its
    directory as a Chrome trace (``hps_trace_<pid>_<n>.json``), with the
    span log beside it (``hps_spans_<pid>_<n>.json``, category ``hps``).
    -> the Chrome trace's path. Raises if no trace is being recorded."""
    global _active, _log, _count
    with _lock:
        if _active is None:
            raise RuntimeError("no trace is being recorded (call start_trace first)")
        trace, _active, _log = _active, None, None
        trace.prof.stop()
        os.makedirs(trace.log_dir, exist_ok=True)
        _count += 1
        stem = f"{os.getpid()}_{_count}.json"
        path = os.path.join(trace.log_dir, f"hps_trace_{stem}")
        trace.prof.export_chrome_trace(path)
        if trace.log is not None:
            _write_spans(trace, path, os.path.join(trace.log_dir, f"hps_spans_{stem}"))
    return path


def _clock_offset_us(trace: _Trace, chrome_path: str) -> float:
    """Chrome-trace µs minus CLOCK_MONOTONIC µs, from the narrowest
    ``CLOCK_RANGE`` stamp (midpoint against midpoint)."""
    with open(chrome_path) as f:
        ranges = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") == CLOCK_RANGE and e.get("cat") == "user_annotation"]
    if len(ranges) != len(trace.clock):
        raise RuntimeError(f"the trace holds {len(ranges)} of {len(trace.clock)} "
                           f"{CLOCK_RANGE} ranges")
    ranges.sort(key=lambda e: e["ts"])
    e, (a, b) = min(zip(ranges, trace.clock), key=lambda p: p[1][1] - p[1][0])
    return e["ts"] + e.get("dur", 0) / 2 - (a + b) / 2e3


def _write_spans(trace: _Trace, chrome_path: str, path: str) -> None:
    off = _clock_offset_us(trace, chrome_path)
    pid = os.getpid()
    events = []
    for name, ids, seq, parent, tid, t0, t1 in list(trace.log.entries):
        args = dict(ids, seq=seq)
        if tid is None:
            # No thread spans it (a request's wait in the queue): an async
            # slice of its own, keyed by the request (by itself without one).
            rid = ids.get("request")
            key = f"request-{rid}" if rid is not None else f"span-{seq}"
            for ph, t in (("b", t0), ("e", t1)):
                events.append({"ph": ph, "cat": "hps", "name": name, "id": key, "pid": pid,
                               "tid": 0, "ts": t / 1e3 + off, "args": args})
            continue
        if parent is not None:
            args["parent"], args["parent_seq"] = parent[1], parent[0]
        events.append({"ph": "X", "cat": "hps", "name": name, "pid": pid, "tid": tid,
                       "ts": t0 / 1e3 + off, "dur": (t1 - t0) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped_spans": trace.log.dropped,
                                 "clock_offset_us": off}}, f)
