"""The general traffic generator: a mix's parameters (``traffic/<name>.json``)
and a configuration's tables give the requests of a run, from the seed.

Parameters of a mix:

- ``loop``: "open" (arrivals on a schedule, whatever the answers) or
  "closed" (``clients`` callers, each sending its next request when its last
  is answered);
- ``rate_rps`` (open): requests a second; the window holds exactly
  ``n = round(rate_rps * seconds)`` arrivals of a Poisson process: the gaps
  between them are the n quantiles ``-ln(1 - (i + 1/2) / n) / rate_rps`` of
  the exponential distribution, scaled to fill the window, in an order drawn
  from the seed. Every seed brings the same work and the same set of gaps,
  in another order;
- ``pool``: distinct requests that the sends cycle through, in an order
  drawn from the seed (the closed loop always has one; an open loop without
  one sends a new request each time);
- ``samples_per_request``; ``zipf_exponent``: each key's row is drawn from
  Zipf(s) truncated to its table's rows (rank k with weight k**-s, rank 1
  the hottest row); ``absent_share``: the share of keys absent from every
  table (negative keys), which get the default vector;
- ``warm_s``: seconds of the same traffic (other requests, from another
  stream of the seed) sent before the window opens, so that the window finds
  the program in its steady state; they count as set-up and are not judged;
- ``connections`` (open): the load generator's connections, enough that a
  request never waits for one; ``clients`` (closed): the callers, each on a
  connection of its own;
- ``keep_bodies``: "all", or how many requests (drawn from the seed) have
  their answer kept whole for the report of the largest gap; every answer
  is checked by digest.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hpsbench.tables import Layout, seed_streams


@dataclasses.dataclass
class Request:
    """``rows[t]``: the row of each key of table t (-1: absent), in the
    request's own order; ``keys[t]`` the keys sent. A one-key-space
    configuration has one "table" whose rows index the tables' concatenation
    and whose keys are sample-major (a sample's keys, one a table, in turn)."""

    samples: int
    rows: list
    keys: list


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    c = np.cumsum(w)
    return c / c[-1]


class Generator:
    def __init__(self, mix: dict, layout: Layout, one_key_space: bool, seed: int,
                 stream: int = 2):
        self.mix = mix
        self.layout = layout
        self.one_key_space = one_key_space
        self.rng = np.random.default_rng([seed_streams(seed), stream])
        self._cdf = {}

    def _rows(self, t: int, n: int) -> np.ndarray:
        rows_t = self.layout.rows[t]
        if rows_t not in self._cdf:
            self._cdf[rows_t] = _zipf_cdf(rows_t, float(self.mix["zipf_exponent"]))
        r = np.searchsorted(self._cdf[rows_t], self.rng.random(n), side="right")
        r = np.minimum(r, rows_t - 1).astype(np.int64)
        r[self.rng.random(n) < float(self.mix.get("absent_share", 0.0))] = -1
        return r

    def _keys(self, t: int, rows: np.ndarray) -> np.ndarray:
        keys = self.layout.keys(t, np.maximum(rows, 0))
        absent = rows < 0
        keys[absent] = -1 - self.rng.integers(0, 1 << 40, int(absent.sum()))
        return keys

    def batch(self, n: int, samples: int) -> list:
        """n requests of ``samples`` samples, drawn table by table in bulk."""
        n_tables = len(self.layout.rows)
        rows = [self._rows(t, n * samples).reshape(n, samples) for t in range(n_tables)]
        keys = [self._keys(t, r.reshape(-1)).reshape(n, samples) for t, r in enumerate(rows)]
        if not self.one_key_space:
            return [Request(samples, [r[i] for r in rows], [k[i] for k in keys])
                    for i in range(n)]
        off = self.layout.offsets
        glob = np.stack([np.where(r < 0, -1, r + off[t]) for t, r in enumerate(rows)], 2)
        kall = np.stack(keys, 2)
        return [Request(samples, [glob[i].reshape(-1)], [kall[i].reshape(-1)])
                for i in range(n)]

    def requests(self, seconds: float):
        """-> (requests, schedule, order): the distinct requests; for the open
        loop the send offsets in seconds (None for the closed loop); and the
        entry of ``requests`` each send takes: the open loop's slot i sends
        ``order[i]`` (each its own request, or with a ``pool`` the pool's
        entries in a drawn order), the closed loop's clients take ``order``
        in turn."""
        b = int(self.mix["samples_per_request"])
        pool = self.mix.get("pool")
        if self.mix["loop"] == "open":
            n = max(int(round(float(self.mix["rate_rps"]) * seconds)), 1)
            if pool is None:
                return self.batch(n, b), self.arrivals(n, seconds), np.arange(n)
            reqs = self.batch(int(pool), b)
            return reqs, self.arrivals(n, seconds), self.order(n)
        reqs = self.batch(int(pool), b)
        return reqs, None, self.order(int(seconds * 10_000) + int(pool))

    def arrivals(self, n: int, seconds: float) -> np.ndarray:
        """n send offsets in [0, seconds): exponential gaps by quantile, in
        an order drawn from the seed; the first comes after one gap."""
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = self.rng.permutation(gaps) * (seconds / (gaps.sum() + gaps.mean()))
        return np.cumsum(gaps)

    def order(self, n: int) -> np.ndarray:
        """The closed loop's sequence of pool entries (long enough for any
        window): a fresh permutation of the pool after another."""
        pool = int(self.mix["pool"])
        return np.concatenate([self.rng.permutation(pool) for _ in range(-(-n // pool))])[:n]
