"""The profiled slice of a traced run: ``torch.profiler`` over a few seconds
in the middle of the window, on the server's process (every thread), reduced
to the device's operations and the host's activity around its idle gaps."""

from __future__ import annotations

import dataclasses
import time

#: Operations shown in a breakdown (each list), and a name's length there.
TOP = 10
NAME_LEN = 160


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    thread: object  # the host thread that launched it (None where unknown)


@dataclasses.dataclass
class HostOp:
    name: str
    start_us: float
    end_us: float
    thread: object


@dataclasses.dataclass
class Slice:
    t0: float        # CLOCK_MONOTONIC seconds
    t1: float
    ops: list        # DeviceOp, every kernel, copy and set of the slice
    host: list       # HostOp, every host op of every thread, nested ones too
    stopped: float   # the profiler stopped: its stop stalls the server too

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        """[start, end, the op that opened it]: the union of the device ops'
        intervals, in time order."""
        merged = []
        for o in sorted(self.ops, key=lambda o: (o.start_us, o.end_us)):
            if merged and o.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end_us)
            else:
                merged.append([o.start_us, o.end_us, o])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self.busy_intervals()) / 1e6

    def gap_name(self, s: float, e: float, thread) -> str:
        """What the host was doing in the idle gap [s, e]: the host op that
        overlaps the gap most, the innermost of those that overlap it as
        much, on the thread that launched the device op ending it; on any
        thread where that thread ran none in the gap or is unknown."""
        over = [(min(e, h.end_us) - max(s, h.start_us), h.start_us - h.end_us, h)
                for h in self.host]
        over = [o for o in over if o[0] > 0]
        pick = [o for o in over if o[2].thread == thread] or over
        return max(pick, key=lambda o: o[:2])[2].name if pick else "no host op traced"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by ``gap_name``."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end_us - o.start_us) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0], b[2].thread) for a, b in zip(busy, busy[1:])),
                      key=lambda g: -g[0])[:TOP]
        named = [[self.gap_name(s, e, th)[:NAME_LEN], length / 1e6]
                 for length, s, e, th in gaps]
        return {"device_ops": [[n[:NAME_LEN], s] for n, s in ops], "idle_gaps": named}


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profiler():
    """A profiler of every thread: the server's handlers and batchers were
    started before it, and without this it records host ops of the thread
    that starts it alone."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import profile

    return profile(activities=_activities(),
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def warm() -> None:
    """Start and stop the profiler once (set-up of a traced run), so that
    its own start-up does not fall into the slice."""
    with _profiler():
        time.sleep(0.05)


@dataclasses.dataclass
class Recording:
    """A profiled stretch whose events are not read yet."""
    prof: object
    t0: float
    t1: float
    stopped: float


def record(seconds: float) -> Recording:
    """Profile every thread of this process for ``seconds``. Its events are
    read by ``read`` once the window has closed: reading them holds the
    interpreter lock, and with every server thread recorded that is about a
    second, which would stall the server inside the window."""
    with _profiler() as prof:
        t0 = time.monotonic()
        time.sleep(seconds)
        t1 = time.monotonic()
    return Recording(prof, t0, t1, time.monotonic())


def read(rec: Recording) -> Slice:
    import sys

    from torch.autograd import DeviceType

    events = rec.prof.events()
    # The host ops that launch device work (the profiler's own association:
    # a device op's linked correlation id is the id of such an op).
    cpu = {e.id: e for e in events if e.device_type == DeviceType.CPU
           and getattr(e, "linked_correlation_id", 0) == 0}
    ops, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            launch = cpu.get(getattr(e, "linked_correlation_id", 0))
            ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                                None if launch is None else launch.thread))
        elif e.device_type == DeviceType.CPU:
            host.append(HostOp(e.name, e.time_range.start, e.time_range.end, e.thread))
    print(f"profiled slice: {rec.t1 - rec.t0:.4f} s, stopped in "
          f"{rec.stopped - rec.t1:.4f} s, {len(events)} events, {len(ops)} on the device, "
          f"{len(host)} on the host", file=sys.stderr, flush=True)
    return Slice(rec.t0, rec.t1, ops, host, rec.stopped)
