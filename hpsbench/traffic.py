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
- ``samples_per_request``: one size for every request, or a list of sizes
  (a quantile table written as its percentiles is one) from which each
  request draws its own, uniformly, from stream (s, 2) of the seed (s: the
  generator's stream); ``zipf_exponent``: each key's row is drawn from
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

What the configuration adds to each request:

- ``keys_per_table_per_sample``, one count for every table or a list of one
  a table: table t's hotness k_t, each sample's bag of k_t keys there (each
  drawn as above, so a bag may repeat a row). ``rows[t]`` and ``keys[t]``
  hold samples x k_t entries, sample-major, as the HPS contract sends them
  (``KEYS`` table-major, ``NUMKEYS`` one count a table). Where every k_t is
  1 the draws are those of one key a table. A ``one_key_space``
  configuration takes 1 only;
- ``num_dense`` (absent or 0: none): ``Request.dense``, [samples,
  num_dense] float32, each feature ``log(1 + k)``, k = r - 1 for a rank r
  drawn from Zipf(1.2) truncated to 1..65,536 (weight r**-1.2; k in
  0..65,535), as MLPerf's DLRM reads Criteo's 13 integer counts; from stream
  (s, 1) of the seed, so that adding features moves no key.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hpsbench import tables

#: The dense features' draw: Zipf's exponent and its count of values.
DENSE_ZIPF = (1.2, 1 << 16)


@dataclasses.dataclass
class Request:
    """``rows[t]``: the row of each key of table t (-1: absent), in the
    request's own order; ``keys[t]`` the keys sent. A one-key-space
    configuration has one "table" whose rows index the tables' concatenation
    and whose keys are sample-major (a sample's keys, one a table, in turn).
    ``dense``: [samples, num_dense] float32, or None without dense features."""

    samples: int
    rows: list
    keys: list
    dense: np.ndarray | None = None


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    c = np.cumsum(w)
    return c / c[-1]


class Generator:
    """A mix's requests over ``layout`` from stream ``stream`` of the seed;
    ``hotness`` and ``num_dense`` as the configuration gives them
    (``for_config``)."""

    def __init__(self, mix: dict, layout: tables.Layout, one_key_space: bool, seed: int,
                 stream: int = 2, hotness=1, num_dense: int = 0):
        n_tables = len(layout.rows)
        self.hotness = ([int(hotness)] * n_tables if np.ndim(hotness) == 0
                        else [int(k) for k in hotness])
        if len(self.hotness) != n_tables or min(self.hotness) < 1:
            raise ValueError(f"keys_per_table_per_sample {hotness!r}: a count of 1 or more "
                             f"for each of the {n_tables} tables")
        if one_key_space and max(self.hotness) > 1:
            raise ValueError("a one_key_space configuration takes one key a table a sample")
        self.mix = mix
        self.layout = layout
        self.one_key_space = one_key_space
        self.num_dense = int(num_dense or 0)
        self.rng = tables.stream(seed, stream)
        self._dense_rng = tables.stream(seed, stream, 1)
        self._size_rng = tables.stream(seed, stream, 2)
        self._cdf = {}

    @classmethod
    def for_config(cls, cfg: dict, mix: dict, layout: tables.Layout, seed: int,
                   stream: int = 2) -> "Generator":
        return cls(mix, layout, cfg["one_key_space"], seed, stream,
                   cfg.get("keys_per_table_per_sample", 1), cfg.get("num_dense", 0))

    def _zipf(self, n: int, s: float) -> np.ndarray:
        if (n, s) not in self._cdf:
            self._cdf[n, s] = _zipf_cdf(n, s)
        return self._cdf[n, s]

    def _rows(self, t: int, n: int) -> np.ndarray:
        rows_t = self.layout.rows[t]
        cdf = self._zipf(rows_t, float(self.mix["zipf_exponent"]))
        r = np.searchsorted(cdf, self.rng.random(n), side="right")
        r = np.minimum(r, rows_t - 1).astype(np.int64)
        r[self.rng.random(n) < float(self.mix.get("absent_share", 0.0))] = -1
        return r

    def _keys(self, t: int, rows: np.ndarray) -> np.ndarray:
        keys = self.layout.keys(t, np.maximum(rows, 0))
        absent = rows < 0
        keys[absent] = -1 - self.rng.integers(0, 1 << 40, int(absent.sum()))
        return keys

    def _dense(self, samples: int) -> np.ndarray:
        s, n = DENSE_ZIPF
        k = np.searchsorted(self._zipf(n, s), self._dense_rng.random(samples * self.num_dense),
                            side="right")
        return np.log1p(np.minimum(k, n - 1)).astype(np.float32).reshape(samples, -1)

    def draw(self, sizes) -> list:
        """One request of each size in ``sizes`` (samples), drawn table by
        table in bulk."""
        sizes = [int(b) for b in sizes]
        ends = np.cumsum(sizes).tolist()
        spans = list(zip([0] + ends[:-1], ends))

        def cut(a, k):
            return [a[lo * k: hi * k] for lo, hi in spans]

        rows = [self._rows(t, ends[-1] * k) for t, k in enumerate(self.hotness)]
        keys = [self._keys(t, r) for t, r in enumerate(rows)]
        dense = cut(self._dense(ends[-1]), 1) if self.num_dense else [None] * len(sizes)
        if self.one_key_space:
            off = self.layout.offsets
            n_t = len(rows)
            rows = [cut(np.stack([np.where(r < 0, -1, r + off[t]) for t, r in enumerate(rows)],
                                 1).reshape(-1), n_t)]
            keys = [cut(np.stack(keys, 1).reshape(-1), n_t)]
        else:
            rows = [cut(r, k) for r, k in zip(rows, self.hotness)]
            keys = [cut(x, k) for x, k in zip(keys, self.hotness)]
        return [Request(b, [r[i] for r in rows], [x[i] for x in keys], dense[i])
                for i, b in enumerate(sizes)]

    def batch(self, n: int, samples: int) -> list:
        """n requests of ``samples`` samples."""
        return self.draw([samples] * n)

    def sizes(self, n: int) -> list:
        """The sizes of n requests: the mix's one size, or n drawn uniformly
        from its list."""
        b = self.mix["samples_per_request"]
        if np.ndim(b) == 0:
            return [int(b)] * n
        if not len(b) or min(b) < 1:
            raise ValueError(f"samples_per_request {b!r}: sizes of 1 or more")
        return self._size_rng.choice(np.asarray(b, np.int64), n).tolist()

    def requests(self, seconds: float):
        """-> (requests, schedule, order): the distinct requests; for the open
        loop the send offsets in seconds (None for the closed loop); and the
        entry of ``requests`` each send takes: the open loop's slot i sends
        ``order[i]`` (each its own request, or with a ``pool`` the pool's
        entries in a drawn order), the closed loop's clients take ``order``
        in turn."""
        pool = self.mix.get("pool")
        if self.mix["loop"] == "open":
            n = max(int(round(float(self.mix["rate_rps"]) * seconds)), 1)
            if pool is None:
                return self.draw(self.sizes(n)), self.arrivals(n, seconds), np.arange(n)
            reqs = self.draw(self.sizes(int(pool)))
            return reqs, self.arrivals(n, seconds), self.order(n)
        reqs = self.draw(self.sizes(int(pool)))
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
