"""The whole request path, from the client's side: the 95th percentile
latency of the window's requests (from due time; a failed request is the
slowest), leaving out those open during the profiled slice, ms."""

from hpsbench import stats


def read(ctx):
    lat = ctx.results.latencies(ctx.untraced) * 1e3
    return stats.percentile(lat, 95) if lat.size else None
