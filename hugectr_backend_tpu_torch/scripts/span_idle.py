"""Where the card idles in a ``start_trace`` of the server: its idle time split
by the stage the batcher's threads were in, and how many device-to-host
copies lie inside an ``hps.dispatch.copy_back`` span.

    python3 -m hugectr_backend_tpu_torch.scripts.span_idle TRACE.json

``TRACE.json`` is a Chrome trace that ``utils/tracing.py stop_trace`` wrote:
the profiler's, of every thread, which holds the spans' ``record_function``
ranges beside the card's operations. The batcher's threads are those with
``hps.batch`` ranges. It prints one JSON line:

- ``skew_us``: how far the device's timestamps run ahead of the host's, as
  the trace shows it: the most by which a device operation starts before
  the CUDA runtime call that issued it (0 where none does). Device
  operations are moved back by it before they are compared with the spans;
- ``window_ms``, ``busy_ms``, ``idle_ms``: from the first to the last device
  operation, the union of the operations (kernels, copies, sets) and the
  rest;
- ``idle_by_stage_ms``: each batcher thread's split of the idle time by the
  stage it was in (``STAGES``; ``hps.batch`` for a batch's time between
  stages; ``another thread's batch`` where it was out of a batch and
  another batcher thread in one), averaged over the threads, and ``no batch
  in the program`` where no batcher thread was in a batch; the entries sum
  to ``idle_ms``;
- ``dtoh_in_copy_back``: of the device-to-host copies, the share (by count
  and by device time) that lies inside an ``hps.dispatch.copy_back`` range.
"""

from __future__ import annotations

import argparse
import json

#: Batcher stages, nearest the device first.
STAGES = ("hps.dispatch.copy_back", "hps.dispatch.launch", "hps.dispatch.assemble",
          "hps.dispatch.translate", "hps.dispatch.lock_wait", "hps.batch.merge",
          "hps.batch.split")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_BATCH = "no batch in the program"
OTHER_BATCH = "another thread's batch"


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _subtract(a, b):
    """Sorted disjoint intervals ``a`` less the union ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def _length(iv) -> float:
    return sum(e - s for s, e in iv)


def skew_us(device: list, events: list) -> float:
    """The most by which a device operation of ``device`` starts before the
    runtime call that issued it (linked by ``args.correlation``); 0 where
    every operation follows its call, as causality asks."""
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    leads = [calls[c] - e["ts"] for e in device
             if (c := e.get("args", {}).get("correlation")) in calls]
    return max([0.0] + leads)


def breakdown(events: list) -> dict:
    """The summary the module docstring describes, of a Chrome trace's
    ``traceEvents`` (times in µs; the result in ms, the skew in µs)."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    # The spans' host ranges (the profiler also draws a range that encloses
    # device work on the device's row, as "gpu_user_annotation").
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("hps.")]
    batcher = sorted({e["tid"] for e in ranges if e["name"] == "hps.batch"})
    if not device:
        return {"skew_us": 0.0, "window_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0,
                "idle_by_stage_ms": {}, "dtoh_in_copy_back": None,
                "batcher_threads": len(batcher)}
    skew = skew_us(device, events)
    busy = _union((e["ts"] + skew, e["ts"] + skew + e["dur"]) for e in device)
    window = [[busy[0][0], busy[-1][1]]]
    idle = _subtract(window, busy)
    idle_len = _length(idle)

    def held(name, tids):
        return _union((e["ts"], e["ts"] + e["dur"]) for e in ranges
                      if e["name"] == name and e["tid"] in tids)

    no_batch = _length(_subtract(idle, held("hps.batch", set(batcher))))
    split = dict.fromkeys(STAGES + ("hps.batch", OTHER_BATCH), 0.0)
    for tid in batcher:
        rest = idle
        for name in STAGES + ("hps.batch",):
            left = _subtract(rest, held(name, {tid}))
            split[name] += (_length(rest) - _length(left)) / len(batcher)
            rest = left
        split[OTHER_BATCH] += (_length(rest) - no_batch) / len(batcher)
    split[NO_BATCH] = no_batch
    copies = [e for e in device if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    backs = held("hps.dispatch.copy_back", {e["tid"] for e in ranges})
    inside = [c for c in copies if any(s <= c["ts"] + skew and c["ts"] + skew + c["dur"] <= e
                                       for s, e in backs)]
    share = None
    if copies:
        share = {"count": len(inside) / len(copies),
                 "device_time": (sum(c["dur"] for c in inside)
                                 / max(sum(c["dur"] for c in copies), 1e-9)),
                 "copies": len(copies)}
    return {"skew_us": skew, "window_ms": _length(window) / 1e3, "busy_ms": _length(busy) / 1e3,
            "idle_ms": idle_len / 1e3,
            "idle_by_stage_ms": {k: v / 1e3 for k, v in split.items()},
            "dtoh_in_copy_back": share, "batcher_threads": len(batcher)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a Chrome trace written by utils/tracing.py stop_trace")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        print(json.dumps(breakdown(json.load(f)["traceEvents"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
