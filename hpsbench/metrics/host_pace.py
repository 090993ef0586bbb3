"""The host's pace in the traced run: the pace probe's units of host work a
wall-second (``hpsbench/pace.py``), the median over its bursts inside the
window, those that overlap the profiled slice until the profiler had stopped
left out."""


def read(ctx):
    return ctx.host_pace
