"""The host's pace: a fixed piece of host work shaped like the server's,
timed inside the run, so that the cell's rate can be read beside the pace of
the host that served it.

    python3 -m hpsbench.pace <out.json>

One *unit*: a pure-Python loop over dicts and attributes (a handler's
bookkeeping), ``np.unique`` and ``np.searchsorted`` of 1,664 int64 keys into a
sorted array of 2,218,317 keys (the b64 cell's translation) and a copy of
851,968 bytes (one b64 answer). Its data comes from a constant seed, never
from the run's. A *burst* is ``UNITS`` units; for each burst the probe records
its start and end on CLOCK_MONOTONIC (the clock of ``time.monotonic`` in
every process) and its thread's CPU seconds. The pace is units per
wall-second, the median over the bursts read.

The probe runs as a process of its own, out of the server's, so that it holds
none of the server's interpreter lock. It prints ``ready`` once its data is
built, runs a burst every ``EVERY_S`` seconds (every burst's time / ``DUTY``
where that is longer) until its standard input says ``stop`` or closes, then
writes its bursts, and its process's CPU seconds after each, to <out.json>
and prints ``done``. The harness starts it beside the load generator and
stops it once the load generator has finished.

Besides the probe: readings of ``/proc`` for the run's log (the host's steal
and iowait shares; the server threads' run-queue wait, non-voluntary
switches and last CPUs). This module imports numpy and the standard library
only.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time

import numpy as np

#: The probe's data seed: a constant, so that every run times the same work.
DATA_SEED = 0x5EED_0B0E
#: Sorted keys searched (the b64 cell's rows), keys a unit looks up (one b64
#: request: 64 samples x 26 tables) and bytes a unit copies (one b64 answer).
INDEX_ROWS = 2_218_317
UNIT_KEYS = 1_664
ANSWER_BYTES = 851_968
#: Key sets a unit cycles through, so that its searches do not all hit the
#: same cache lines; iterations of its Python loop.
QUERY_SETS = 16
LOOP = 400
#: Units a burst; seconds between the starts of two bursts, stretched where a
#: burst takes more than ``DUTY`` of them, so that the probe holds under a
#: tenth of a core on a slow host too.
UNITS = 20
EVERY_S = 0.25
DUTY = 0.08
#: The reference pace, units a wall-second, that a run's rate is scaled to:
#: the median of the probe's pace over twelve untraced 8 s runs of
#: ``hps-dlrm1tb.b64-c16`` on the host of an NVIDIA H100 80GB HBM3 (8 vCPUs,
#: 700 W), each run's pace the median of its window's bursts.
P_REF = 835.7767405422674


class _Request:
    def __init__(self, i: int):
        self.id = i
        self.samples = 64
        self.meta = {"model": "hps", "n": i}


class Work:
    """The data of a unit, built from ``DATA_SEED``."""

    def __init__(self):
        rng = np.random.default_rng(DATA_SEED)
        self.index = np.sort(rng.integers(0, 1 << 56, INDEX_ROWS))
        present = UNIT_KEYS - UNIT_KEYS // 100
        self.queries = [np.concatenate([self.index[rng.integers(0, INDEX_ROWS, present)],
                                        rng.integers(0, 1 << 56, UNIT_KEYS - present)])
                        for _ in range(QUERY_SETS)]
        self.answer = np.frombuffer(rng.bytes(ANSWER_BYTES), np.uint8)
        self.done = 0

    def unit(self) -> int:
        """One unit of work. -> a checksum of what it computed."""
        acc = 0
        for i in range(LOOP):
            r = _Request(i)
            d = {"id": r.id, "samples": r.samples, "model": r.meta["model"]}
            acc += d["samples"] + len(d["model"]) + r.meta["n"] % 7
        keys, inverse = np.unique(self.queries[self.done % QUERY_SETS], return_inverse=True)
        pos = np.searchsorted(self.index, keys)
        out = self.answer.tobytes()
        self.done += 1
        return acc + int(pos.sum() % 1_000_003) + int(inverse[-1]) + len(out)


def burst(work: Work, clock=time.monotonic, cpu=time.thread_time) -> list:
    """``UNITS`` units. -> [start, end, the thread's CPU seconds]."""
    c0, t0 = cpu(), clock()
    for _ in range(UNITS):
        work.unit()
    t1, c1 = clock(), cpu()
    return [t0, t1, c1 - c0]


def bursts_in(bursts, t0: float = -np.inf, t1: float = np.inf, skip=None) -> list:
    """The bursts inside [t0, t1], less those that overlap ``skip`` (a
    (start, end) stretch, such as the profiled slice until the profiler had
    stopped)."""
    return [b for b in bursts if b[0] >= t0 and b[1] <= t1
            and (skip is None or b[1] < skip[0] or b[0] > skip[1])]


def _rates(bursts) -> list:
    return [UNITS / (b[1] - b[0]) for b in bursts if b[1] > b[0]]


def pace(bursts):
    """Units a wall-second, the median over ``bursts``; None without any."""
    rates = _rates(bursts)
    return statistics.median(rates) if rates else None


def summary(bursts) -> dict:
    """The log's view of some bursts: how many, the pace's median, minimum
    and maximum (units a wall-second), and the median units a CPU-second of
    the probe's thread."""
    rates, cpu = _rates(bursts), [UNITS / b[2] for b in bursts if b[2] > 0]
    if not rates:
        return {"n": 0}
    return {"n": len(rates), "median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "cpu_median": statistics.median(cpu) if cpu else None}


def paced(rate: float, run_pace):
    """``rate`` scaled to the reference pace: rate x ``P_REF`` / the run's
    pace; None without a pace."""
    return rate * P_REF / run_pace if run_pace else None


def cores(cpu, t0: float, t1: float):
    """The probe process's cores between its first and last CPU reading in
    [t0, t1]; None with fewer than two."""
    inside = [c for c in cpu if t0 <= c[0] <= t1]
    if len(inside) < 2 or inside[-1][0] <= inside[0][0]:
        return None
    return (inside[-1][1] - inside[0][1]) / (inside[-1][0] - inside[0][0])


# -- /proc readings for the run's log ---------------------------------------

def cpu_times():
    """The host's CPU time by kind (``/proc/stat``'s first line: user, nice,
    system, idle, iowait, irq, softirq, steal), in ticks; None where
    unreadable."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def cpu_shares(before, after) -> dict:
    """The steal and iowait shares of the host's CPU time between two
    ``cpu_times`` readings; None where the readings are missing or did not
    move."""
    d = [a - b for a, b in zip(after or [], before or [])]
    total = sum(d)
    if len(d) < 8 or total <= 0:
        return {"steal": None, "iowait": None}
    return {"steal": d[7] / total, "iowait": d[4] / total}


def _read(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def threads() -> dict:
    """{tid: (run ns, run-queue wait ns, non-voluntary switches, last CPU)}
    of every thread of this process (``/proc/self/task/*``; a value that
    cannot be read is None)."""
    base = "/proc/self/task"
    try:
        tids = os.listdir(base)
    except OSError:
        return {}
    out = {}
    for tid in tids:
        sched, status, stat = (_read(f"{base}/{tid}/{name}")
                               for name in ("schedstat", "status", "stat"))
        run_ns = wait_ns = nonvol = cpu = None
        if sched:
            run_ns, wait_ns = (int(v) for v in sched.split()[:2])
        for line in (status or "").splitlines():
            if line.startswith("nonvoluntary_ctxt_switches:"):
                nonvol = int(line.split()[1])
        if stat:
            cpu = int(stat.rsplit(")", 1)[1].split()[36])
        out[int(tid)] = (run_ns, wait_ns, nonvol, cpu)
    return out


def thread_deltas(before: dict, after: dict, seconds: float) -> dict:
    """The threads' run time, run-queue wait and non-voluntary switches
    between two ``threads`` readings (a thread born between them counts from
    0), the wait's share of run + wait, the threads waiting on average, and
    the CPUs the threads were last on."""
    run = wait = nonvol = 0
    for tid, (r, w, n, _) in after.items():
        r0, w0, n0, _ = before.get(tid, (0, 0, 0, None))
        run += (r or 0) - (r0 or 0)
        wait += (w or 0) - (w0 or 0)
        nonvol += (n or 0) - (n0 or 0)
    return {"threads": len(after), "run_s": run / 1e9, "runqueue_wait_s": wait / 1e9,
            "runqueue_wait_share": wait / (run + wait) if run + wait > 0 else None,
            "waiting_threads": wait / 1e9 / seconds if seconds > 0 else None,
            "nonvoluntary_switches": nonvol,
            "last_cpus": sorted({c for *_, c in after.values() if c is not None})}


# -- the probe as a process ---------------------------------------------------

def serve(out_path: str) -> None:
    work = Work()
    burst(work)  # the first touch of the data, not recorded
    stop = threading.Event()

    def read_stdin():
        for line in sys.stdin:
            if line.strip() == "stop":
                break
        stop.set()

    print("ready", flush=True)
    threading.Thread(target=read_stdin, daemon=True).start()
    bursts, cpu = [], []  # cpu: [time, the process's CPU seconds] after each burst
    while not stop.is_set():
        b = burst(work)
        bursts.append(b)
        t = os.times()
        cpu.append([time.monotonic(), t.user + t.system])
        stop.wait(max(b[0] + max(EVERY_S, (b[1] - b[0]) / DUTY) - time.monotonic(), 0.0))
    with open(out_path, "w") as f:
        json.dump({"bursts": bursts, "cpu": cpu}, f)
    print("done", flush=True)


if __name__ == "__main__":
    serve(sys.argv[1])
