"""The whole request path, from the client's side: samples in correctly
answered requests a second, over the window less the profiled slice (the
requests answered inside the slice and the slice's time left out)."""


def read(ctx):
    r = ctx.results
    samples = [ctx.requests[e].samples for e in r.entry]
    keep = r.ok.copy()
    span = 0.0
    if ctx.untraced is not None:
        s0, s1 = ctx.untraced
        keep &= (r.done < s0) | (r.done > s1)
        span = s1 - s0
    seconds = ctx.window_s - span
    if seconds <= 0 or not keep.any():
        return None
    return float(sum(s for s, k in zip(samples, keep) if k)) / seconds
