"""One run of one cell of ``BENCHMARK.json``.

    python3 -m hpsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The program under test is ``hugectr_backend_tpu_torch``'s KServe-v2 HTTP
server, in this process, on the card. Set-up (``setup_s``, from this
process's start to the window's opening): the configuration's tables drawn
from the seed on the card, written in the formats the
program loads, the program's server started on them, every request size of
the cell's traffic sent once before the window, and the load generator's
process (``hpsbench.loadgen``) started with its connections open, beside the
host-pace probe's (``hpsbench.pace``). The window lasts ``--seconds``;
requests still open at its close are waited for, and count. The probe's pace
over the window is the host's, and the window's rate scaled by it is
``paced_samples_per_s``. With ``--trace 1`` a ``torch.profiler`` slice of the
window's middle and the program's histograms over the window give the
per-layer metrics instead of the end-to-end ones; what the host clock and the
histograms give leaves out the slice until the profiler has stopped, so that
the profiler's cost is not read into them, and the slice's events are read
once the window has closed. Then the program's state is freed and every answer is judged
against the plain reference (``deploy/<kind>.py judge``).

The last line of standard output is the result (JSON); the numbers compared
for ``correct`` are also the last lines of standard error. Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded, the run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import select
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from hpsbench import loadgen, pace, spec, stats, tables
from hpsbench import trace as tracing
from hpsbench.deploy import kind as deploy_kind
from hpsbench.metrics import reader
from hpsbench.traffic import Generator

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "hugectr_backend_tpu")
#: The traced slice of a ``--trace 1`` run, seconds (at most a third of the window).
PROFILE_S = 2.0
#: Each warm-up size is sent this many times before the window.
WARM_REPEATS = 2
#: How long past the window's close answers are waited for, seconds.
LATE_S = 90.0
#: The stretch of the window each latency line on stderr covers, seconds.
TIMELINE_S = 2.0
#: The load generator's start-up, seconds.
CLIENT_START_S = 120.0


class Failure(Exception):
    """A run that cannot give a result (no card, a process that died)."""


def process_start() -> float:
    """This process's start on CLOCK_MONOTONIC (``/proc/self/stat``; the
    import time of this module where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc outputs go to ``hugectr_backend_tpu_torch/_build``)."""
    base = spec.HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def card_info(chips: int) -> dict:
    """The card this run uses; raises ``Failure`` without enough cards.
    Prints the card's name, count, power limit and clocks to stderr."""
    import torch

    if not torch.cuda.is_available():
        raise Failure("no CUDA device (torch.cuda.is_available() is False)")
    n = torch.cuda.device_count()
    if n < chips:
        raise Failure(f"the cell asks for {chips} cards, {n} visible")
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e!r})"
    print(f"device: {name}, count {n}; nvidia-smi name, power.limit, clocks.sm, "
          f"clocks.max.sm, clocks.mem: {smi}", file=sys.stderr, flush=True)
    return {"platform": "gpu", "kind": name, "count": chips}


def _readline(proc, timeout: float) -> str:
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        raise Failure(f"the load generator said nothing in {timeout} s")
    line = proc.stdout.readline()
    if not line:
        raise Failure(f"the load generator exited ({proc.wait()})")
    return line.strip()


class Results:
    """The load generator's record of a window."""

    def __init__(self, path: str, attempted: int):
        with np.load(path) as z:
            for k in ("entry", "due", "sent", "done", "status", "digest", "kept_idx",
                      "kept_len", "kept_blob", "errors"):
                setattr(self, k, z[k])
            self.t0 = float(z["t0"])
            self.digest_wait_s = float(z["digest_wait_s"])
            self.client_cores = float(z["cores"])
        # The warm-up's requests (due before the window) are set-up.
        window = np.flatnonzero(self.due >= self.t0)
        for k in ("entry", "due", "sent", "done", "status", "digest"):
            setattr(self, k, getattr(self, k)[window])
        row_of = {int(old): new for new, old in enumerate(window)}
        ends = np.cumsum(self.kept_len)
        self._kept = {}  # window row -> its output's bytes
        for old, n, end in zip(self.kept_idx, self.kept_len, ends):
            if int(old) in row_of:
                self._kept[row_of[int(old)]] = self.kept_blob[end - n: end]
        self.attempted = max(attempted, self.entry.size)
        self.ok = self.status == 200

    @property
    def failed(self) -> int:
        return int(self.attempted - self.ok.sum())

    def kept_rows(self) -> list:
        """The rows whose output was kept whole."""
        return list(self._kept)

    def body(self, i: int):
        """Row i's output tensor (float32), where it was kept whole."""
        raw = self._kept.get(int(i))
        return None if raw is None else np.frombuffer(raw.tobytes(), "<f4")

    def latencies(self, skip=None) -> np.ndarray:
        """Seconds from due to the last byte; inf for every failed or
        missing request. ``skip`` (t0, t1): leave out the requests that were
        open at some time in [t0, t1]."""
        lat = np.where(self.ok, self.done - self.due, np.inf)
        if skip is None:
            return np.concatenate([lat, np.full(self.attempted - lat.size, np.inf)])
        return lat[~self.overlaps(*skip)]

    def overlaps(self, t0: float, t1: float) -> np.ndarray:
        """Rows whose request was open (sent to answered) at some time in
        [t0, t1]."""
        return (self.sent <= t1) & (self.done >= t0)


@dataclasses.dataclass
class Context:
    """What readers and the judge see of a window."""

    cfg: dict
    mix: dict
    limits: dict
    layout: tables.Layout
    vectors: np.ndarray
    requests: list
    results: Results
    device: str
    window_s: float
    hist: dict
    trace: object
    peaks: object
    host_pace: object = None  # the probe's pace over the window, units/s
    seed: int = 0  # the run's seed, from which a judge draws a kind's weights again

    def host_tables(self) -> list:
        if self.cfg["one_key_space"]:
            return [self.vectors]
        off = np.concatenate([[0], np.cumsum(self.layout.rows)])
        return [self.vectors[a:b] for a, b in zip(off[:-1], off[1:])]

    @staticmethod
    def digest(arr: np.ndarray) -> bytes:
        return loadgen.digest(memoryview(np.ascontiguousarray(arr, "<f4")).cast("B"))

    @property
    def untraced(self):
        """The profiled slice, from its start until the profiler had
        stopped, which host-clock readers leave out, or None in an untraced
        run."""
        return None if self.trace is None else (self.trace.t0, self.trace.stopped)

    def answered_in(self, t0: float, t1: float) -> np.ndarray:
        r = self.results
        return np.flatnonzero(r.ok & (r.done >= t0) & (r.done <= t1))

    def answered_samples(self) -> int:
        r = self.results
        return int(sum(self.requests[e].samples for e in r.entry[r.ok]))


def _histograms(model: str) -> dict:
    from hugectr_backend_tpu_torch.serving import metrics

    return {h.name: (h.count(model=model), h.sum(model=model))
            for h in list(metrics.REGISTRY._metrics) if isinstance(h, metrics.Histogram)}


def _delta(after: dict, before: dict) -> dict:
    """Histograms' (count, sum) of ``after`` less ``before``."""
    return {k: (c - before.get(k, (0, 0.0))[0], s - before.get(k, (0, 0.0))[1])
            for k, (c, s) in after.items()}


def host_state() -> str:
    """The host's dirty and writeback pages (for the run's log)."""
    try:
        with open("/proc/meminfo") as f:
            mem = {k: v.strip() for k, v in (line.split(":", 1) for line in f)}
        return f"Dirty {mem.get('Dirty')}, Writeback {mem.get('Writeback')}"
    except OSError as e:
        return f"unreadable ({e})"


def process_cpu_s() -> float:
    """This process's CPU time, every thread, user and system."""
    t = os.times()
    return t.user + t.system


def drop_tables(work: str) -> None:
    """Delete the table files once the program has loaded them: their dirty
    pages are then dropped, not written back to disk during the window
    (and a run writes little to disk)."""
    for root, _, files in os.walk(work):
        for name in files:
            if name in ("key", "emb_vector"):
                os.remove(os.path.join(root, name))


@dataclasses.dataclass
class Window:
    """What ``Session.window`` gives back. ``hist``: the program's histograms
    over the window, less the profiled slice; ``cpu_s``: this process's CPU
    seconds from the window's open until every answer was in; ``probe``: the
    out-of-process pace probe's record (``hpsbench.pace``); ``host``: the
    host's steal and iowait shares and this process's threads over the same
    stretch (for the run's log)."""

    requests: list
    results: Results
    window_s: float
    hist: dict
    slice: object
    setup_s: object
    cpu_s: float
    probe: dict
    host: dict


def warm_requests(cfg: dict, mix: dict, layout: tables.Layout, seed: int) -> list:
    """One request of each size the traffic can make the program run
    (``deploy/<kind>.py warm_sizes``), from stream 3 of the seed."""
    gen = Generator.for_config(cfg, mix, layout, seed, stream=3)
    return [gen.batch(1, size)[0] for size in deploy_kind(cfg).warm_sizes(cfg, mix)]


def window_requests(cfg: dict, mix: dict, layout: tables.Layout, seed: int, seconds: float):
    """-> (requests, sched, order, keep, n_warm): a window's requests (stream
    2), after those of the open loop's warm traffic (stream 5, ``n_warm`` of
    them, due before the window); the open loop's send offsets (the closed
    loop's: none); the entry each send takes; and whether each request's
    answer is kept whole (stream 4)."""
    gen = Generator.for_config(cfg, mix, layout, seed)
    requests, sched, order = gen.requests(seconds)
    warm_s = float(mix.get("warm_s", 0.0))
    n_warm = 0
    if sched is not None and warm_s > 0:
        warm_gen = Generator.for_config(cfg, mix, layout, seed, stream=5)
        warm, warm_sched, warm_order = warm_gen.requests(warm_s)
        n_warm = len(warm)
        requests = warm + requests
        sched = np.concatenate([warm_sched - warm_s, sched])
        order = np.concatenate([warm_order, order + n_warm])
    keep = np.zeros(len(requests), bool)
    if mix.get("keep_bodies", "all") == "all":
        keep[:] = True
    else:
        n_win = len(requests) - n_warm
        keep[n_warm + tables.stream(seed, 4).choice(n_win, min(int(mix["keep_bodies"]), n_win),
                                                    replace=False)] = True
    return requests, sched, order, keep, n_warm


def _start(module: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=str(spec.ROOT),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


class Session:
    """A configuration deployed from one seed and served: ``window`` runs the
    load generator against it (as often as a caller likes, each with its
    own traffic), ``close`` stops the program and frees its state."""

    def __init__(self, cfg: dict, seed: int, device: str, work_root=None):
        import torch

        self.cfg, self.seed, self.device = cfg, seed, device
        self.kind = deploy_kind(cfg)
        self.work = tempfile.mkdtemp(prefix="hpsbench-", dir=work_root)
        self.layout = tables.Layout.make(cfg["rows_per_table"], seed)
        self.vectors = tables.make_rows(sum(self.layout.rows), cfg["embedding_dim"], seed,
                                        device)
        source = self.kind.write(cfg, self.layout, self.vectors, self.work, seed)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.server = self.kind.serve(cfg, source, device)
        self.port = self.server.port
        self.path = self.kind.infer_path(cfg)
        drop_tables(self.work)

    def post(self, body: bytes, hdr_len: int) -> int:
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            c.request("POST", self.path, body=body,
                      headers={"Inference-Header-Content-Length": str(hdr_len),
                               "Content-Type": "application/octet-stream"})
            r = c.getresponse()
            r.read()
            return r.status
        finally:
            c.close()

    def warm(self, mix: dict) -> None:
        """Every request size the traffic can make the program run, sent
        ``WARM_REPEATS`` times."""
        for req in warm_requests(self.cfg, mix, self.layout, self.seed):
            hdr, raw = self.kind.encode(self.cfg, req)
            for _ in range(WARM_REPEATS):
                status = self.post(hdr + raw, len(hdr))
                if status != 200:
                    raise Failure(f"a warm-up request of {req.samples} samples answered "
                                  f"{status}")

    def window(self, mix: dict, seconds: float, trace: bool = False,
               process_t0=None) -> Window:
        """One window of ``mix``, with the pace probe's process running from
        the load generator's start to its end."""
        requests, sched, order, keep, n_warm = window_requests(
            self.cfg, mix, self.layout, self.seed, seconds)
        warm_s = float(mix.get("warm_s", 0.0))
        # The warm traffic's sends are due before the window opens (offsets < 0).
        attempted = 0 if sched is None else int(np.count_nonzero(sched >= 0))
        load = os.path.join(self.work, f"load-{time.monotonic_ns()}")
        os.makedirs(load)
        encoded = [self.kind.encode(self.cfg, r) for r in requests]
        with open(os.path.join(load, "bodies.bin"), "wb") as f:
            for hdr, raw in encoded:
                f.write(hdr)
                f.write(raw)
        lens = np.asarray([len(h) + len(r) for h, r in encoded], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        if mix["loop"] == "open":
            connections = mix["connections"]
        else:
            connections, sched = mix["clients"], np.zeros(0)
        np.savez(os.path.join(load, "arrays.npz"), offsets=offsets,
                 hdr_len=np.asarray([len(h) for h, _ in encoded], np.int64),
                 sched=np.asarray(sched, np.float64), order=np.asarray(order, np.int64),
                 keep=keep)
        plan = {"bodies": os.path.join(load, "bodies.bin"),
                "arrays": os.path.join(load, "arrays.npz"),
                "results": os.path.join(load, "results.npz"), "port": self.port,
                "path": self.path, "loop": mix["loop"], "connections": int(connections),
                "seconds": float(seconds),
                "keep_every_answer": mix.get("keep_bodies", "all") == "all", "warm_s": warm_s}
        with open(os.path.join(load, "plan.json"), "w") as f:
            json.dump(plan, f)
        del encoded
        proc = _start("hpsbench.loadgen", os.path.join(load, "plan.json"))
        probe_out = os.path.join(load, "pace.json")
        probe = _start("hpsbench.pace", probe_out)
        try:
            if _readline(proc, CLIENT_START_S) != "ready":
                raise Failure("the load generator did not start")
            if _readline(probe, CLIENT_START_S) != "ready":
                raise Failure("the pace probe did not start")
            os.remove(plan["bodies"])
            model = self.kind.model_label(self.cfg)
            # The harness's own objects (the requests above all) out of the
            # cyclic collector's way while the program serves.
            gc.collect()
            gc.freeze()
            start = time.monotonic() + 0.05
            t0 = start + warm_s
            setup_s = None if process_t0 is None else t0 - process_t0
            proc.stdin.write(f"go {start!r}\n")
            proc.stdin.flush()
            time.sleep(max(t0 - time.monotonic(), 0))
            cpu0 = process_cpu_s()
            stat0, threads0 = pace.cpu_times(), pace.threads()
            before = _histograms(model)
            print(f"host at the window's open: {host_state()}", file=sys.stderr, flush=True)
            rec, in_slice = None, {}
            if trace:
                span = min(PROFILE_S, seconds / 3)
                time.sleep(max(t0 + (seconds - span) / 2 - time.monotonic(), 0))
                at = _histograms(model)
                rec = tracing.record(span)
                in_slice = _delta(_histograms(model), at)
            if _readline(proc, max(t0 + seconds - time.monotonic(), 0) + LATE_S + 60) != "done":
                raise Failure("the load generator did not finish")
            cpu_s = process_cpu_s() - cpu0
            closed = time.monotonic()
            host = {**pace.cpu_shares(stat0, pace.cpu_times()),
                    **pace.thread_deltas(threads0, pace.threads(), closed - t0)}
            after = _histograms(model)
            gc.unfreeze()
            print(f"host after the window: {host_state()}", file=sys.stderr, flush=True)
            proc.wait(timeout=60)
            if proc.returncode:
                raise Failure(f"the load generator exited {proc.returncode}")
            probe.stdin.write("stop\n")
            probe.stdin.flush()
            if _readline(probe, 60) != "done":
                raise Failure("the pace probe did not finish")
            probe.wait(timeout=60)
            with open(probe_out) as f:
                probe_rec = json.load(f)
        finally:
            for p in (proc, probe):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        sl = None if rec is None else tracing.read(rec)
        res = Results(plan["results"], attempted)
        last = float(res.done[res.ok].max()) if res.ok.any() else t0 + seconds
        window_s = max(last, t0 + seconds) - t0
        hist = _delta(_delta(after, before), in_slice)
        shutil.rmtree(load, ignore_errors=True)
        return Window(requests, res, window_s, hist, sl, setup_s, cpu_s, probe_rec, host)

    def close(self) -> None:
        self.server.stop()
        self.server = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def resident_bytes(device: str) -> int:
    """The device memory the program's live tensors hold (the card's
    allocator), once every request so far has been answered; 0 on the CPU."""
    if device == "cpu":
        return 0
    import torch

    gc.collect()
    torch.cuda.synchronize()
    return int(torch.cuda.memory_allocated())


def end_to_end(res: Results, window_s: float, samples: int, resident: int,
               host_pace=None) -> dict:
    """The device memory the deployment holds once loaded and warmed up
    (``memory_resident_mb``); the window's rate, samples in correctly
    answered requests over the window's seconds, scaled to the reference
    host pace (``paced_samples_per_s``: ``samples_per_s`` x ``pace.P_REF`` /
    the run's probe pace); and the rate and latencies as read, for the
    run's log."""
    lat = res.latencies() * 1e3
    rate = samples / window_s if window_s > 0 else 0.0
    return {"memory_resident_mb": resident / 1e6, "samples_per_s": rate,
            "paced_samples_per_s": pace.paced(rate, host_pace),
            "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95)}


def pace_readings(w: Window, seconds: float) -> dict:
    """The host's pace in this run: the probe's bursts inside the window, less
    those that overlap the profiled slice until the profiler had stopped, and
    the probe's cores over the window; beside them, for the log, the host's
    steal and iowait shares and this process's threads over the window."""
    t0, t1 = w.results.t0, w.results.t0 + seconds
    skip = None if w.slice is None else (w.slice.t0, w.slice.stopped)
    bursts = pace.bursts_in(w.probe["bursts"], t0, t1, skip)
    return {"probe": {**pace.summary(bursts), "cores": pace.cores(w.probe["cpu"], t0, t1)},
            "host": w.host}


def judge(ctx: Context, control=None) -> dict:
    """-> {check: (value, limit)}: the kind's comparison with the reference,
    and the requests that failed or never came back."""
    checks = deploy_kind(ctx.cfg).judge(ctx, control)
    if control is None:
        checks["failed_requests"] = (ctx.results.failed, ctx.limits["failed_requests"])
    return checks


def passes(checks: dict) -> bool:
    return all(lim is None or (math.isfinite(v) and v <= lim) for v, lim in checks.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             process_t0=None, device_info=None) -> dict:
    """One run of ``cell``. -> the result line's object."""
    session = Session(cell.cfg, seed, device)
    try:
        session.warm(cell.mix)
        resident = resident_bytes(device)
        if device != "cpu":
            import torch

            print(f"device memory after the warm-up: {resident} B held, "
                  f"{torch.cuda.max_memory_allocated()} B at the peak", file=sys.stderr, flush=True)
        if trace:
            tracing.warm()
        w = session.window(cell.mix, seconds, trace, process_t0)
        res, window_s, sl = w.results, w.window_s, w.slice
        info = dict(device_info or {"platform": device, "kind": device, "count": 1})
        if device != "cpu":
            import torch

            info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        else:
            info["memory_peak_bytes"] = 0
        session.close()
        ctx = Context(cell.cfg, cell.mix, cell.limits, session.layout, session.vectors,
                      w.requests, res, device, window_s, w.hist, sl,
                      spec.peaks(info["kind"]), seed=seed)
        t_judge = time.monotonic()
        checks = judge(ctx)
        print(f"judged in {time.monotonic() - t_judge:.3f} s", file=sys.stderr, flush=True)
    finally:
        if session.server is not None:
            session.close()
        session.cleanup()
    late = stats.lateness(res.due, res.sent)
    print(f"latency by {TIMELINE_S:g} s of due time (answered, p50 / p95 ms): "
          f"{stats.timeline(res.due - res.t0, res.done - res.due, res.ok, TIMELINE_S)}",
          file=sys.stderr, flush=True)
    host = pace_readings(w, seconds)
    ctx.host_pace = host["probe"].get("median")
    e2e = end_to_end(res, window_s, ctx.answered_samples(), resident, ctx.host_pace)
    e2e["setup_s"] = w.setup_s if w.setup_s is not None else float("nan")
    print(f"host pace: {json.dumps(host)}", file=sys.stderr, flush=True)
    cpu_s = w.cpu_s
    print(f"window: {res.attempted} attempted, {res.failed} failed, {window_s:.4f} s; "
          f"e2e {json.dumps(e2e)}; the program's CPU {cpu_s:.3f} s "
          f"({cpu_s / window_s:.3f} cores); generator lateness {json.dumps(late)}; "
          f"the load generator's CPU {res.client_cores:.3f} cores, its callers waited "
          f"{res.digest_wait_s:.4f} s for its digests; "
          f"client errors {res.errors.tolist()[:5]}", file=sys.stderr, flush=True)
    out = {"correct": passes(checks), "attempted": int(res.attempted),
           "failed": int(res.failed)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        info["busy_s"] = sl.busy_s if sl is not None else 0.0
        info["window_s"] = sl.wall_s if sl is not None else 0.0
        out["device"] = info
        if sl is not None:
            out["breakdown"] = sl.breakdown()
    else:
        out["metrics"] = {m["name"]: {"value": _finite(e2e[m["name"]]), "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = info
    out["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return out


def _finite(v):
    return float(v) if v is not None and math.isfinite(v) else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    process_t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        set_cache_dirs()
        cell = spec.load(args.workload)
        info = card_info(cell.chips)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", process_t0, info)
    except Failure as e:
        print(f"hpsbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"hpsbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
