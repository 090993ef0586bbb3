"""Readings that the limits of ``limits/<config>.json`` are set from: for
each seed, a short window of the cell's own traffic at its own sizes judged
against the reference (the program's reading), and the control judged on the
same requests (the reference at the precision below the configuration's,
put in the program's place: int4 rows for the int8 HPS model).

    python3 -m hpsbench.readings --workload <cell> --seeds 1,2,3 --seconds 3 [--control-seeds 1,2,3]

Prints one JSON line a seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from hpsbench import run, spec

def reading(cell, seed: int, seconds: float, device: str, control: bool) -> dict:
    session = run.Session(cell.cfg, seed, device)
    try:
        session.warm(cell.mix)
        w = session.window(cell.mix, seconds)
        res = w.results
        session.close()
        ctx = run.Context(cell.cfg, cell.mix, cell.limits, session.layout, session.vectors,
                          w.requests, res, device, w.window_s, w.hist, None, None, seed=seed)
        out = {"seed": seed, "answered": int(res.ok.sum()), "failed": res.failed,
               "program": {k: v for k, (v, _) in run.judge(ctx).items()}}
        if control:
            out["control"] = {k: v for k, (v, _) in
                              run.judge(ctx, run.deploy_kind(cell.cfg).CONTROL).items()}
        return out
    finally:
        if session.server is not None:
            session.close()
        session.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = spec.load(args.workload)
    info = run.card_info(cell.chips)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(s) for s in args.seeds.split(",")):
        line = reading(cell, s, args.seconds, "cuda", s in ctl)
        print(json.dumps({"workload": cell.name, "device": info["kind"], **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
