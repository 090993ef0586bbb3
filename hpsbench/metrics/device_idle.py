"""Device: the share of the profiled slice in which no kernel, copy or set
ran on the card, 1 - (union of their intervals / the slice's wall), %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
