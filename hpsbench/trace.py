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
    host_ops: tuple  # names of the host ops that launched it, innermost first


@dataclasses.dataclass
class Slice:
    t0: float        # CLOCK_MONOTONIC seconds
    t1: float
    ops: list        # DeviceOp, every kernel, copy and set of the slice
    host: list       # (name, start_us, end_us) of the host's outermost ops

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        iv = sorted((o.start_us, o.end_us) for o in self.ops)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host op that overlapped each most."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.end_us - o.start_us) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:TOP]
        named = []
        for length, s, e in gaps:
            best, name = 0.0, "no host op traced"
            for hname, hs, he in self.host:
                ov = min(e, he) - max(s, hs)
                if ov > best:
                    best, name = ov, hname
            named.append([name[:NAME_LEN], length / 1e6])
        return {"device_ops": [[n[:NAME_LEN], s] for n, s in ops], "idle_gaps": named}


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm() -> None:
    """Start and stop the profiler once (set-up of a traced run), so that
    its own start-up does not fall into the slice."""
    from torch.profiler import profile

    with profile(activities=_activities()):
        time.sleep(0.05)


def record(seconds: float) -> Slice:
    """Profile every thread of this process for ``seconds``."""
    import sys

    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        t0 = time.monotonic()
        time.sleep(seconds)
        t1 = time.monotonic()
    events = prof.events()
    # The host ops that launch device work (the profiler's own association:
    # a device op's linked correlation id is the id of such an op).
    cpu = {e.id: e for e in events if e.device_type == DeviceType.CPU
           and getattr(e, "linked_correlation_id", 0) == 0}
    ops, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            chain, p = [], cpu.get(getattr(e, "linked_correlation_id", 0))
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end, tuple(chain)))
        elif e.device_type == DeviceType.CPU and e.cpu_parent is None:
            host.append((e.name, e.time_range.start, e.time_range.end))
    print(f"profiled slice: {t1 - t0:.4f} s, {len(events)} events, {len(ops)} on the "
          f"device, {len(host)} outermost host ops", file=sys.stderr, flush=True)
    return Slice(t0, t1, ops, host)
