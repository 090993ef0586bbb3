"""The configuration's tables, made from the seed.

Row values come from one ``torch.Generator`` on the run's device, in one
call (float32, N(0, 1)), and go to the host once: the program loads them
from the files ``deploy/<kind>.py`` writes, the reference reads the same
arrays. Keys are hashed ids: table t's row r has the key
``t << 56 | (r * mult_t + add_t) mod 2**56`` (``mult_t`` odd), a bijection,
so keys are unique within a table and across tables, and the sorted order
the program stores rows in has nothing to do with the rows' order. The
tables of a ``one_key_space`` configuration are served as one table.

Every draw of a run comes from the seed, each from a stream of its own
(``stream``), so that a new draw never moves an old one.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KEY_BITS = 56
_KEY_MASK = (1 << KEY_BITS) - 1


def seed_streams(seed: int) -> int:
    """The seed as a non-negative integer (``--seed`` may be any integer)."""
    return int(seed) % (1 << 63)


def stream(seed: int, *path: int) -> np.random.Generator:
    """A NumPy generator for the named stream ``path`` of the seed. Streams
    in use (a path's last number is never 0, so no path repeats a shorter one):

    - 1: the layout (each table's key hash);
    - 2: the window's traffic (``traffic.Generator``'s default);
    - 3: the warm-up's requests, one a size (``run.Session.warm``);
    - 4: the requests whose answers are kept whole;
    - 5: the warm traffic sent before the window opens;
    - (s, 1): the dense features of traffic stream s (s 2, 3 or 5), where
      the configuration has ``num_dense``;
    - (s, 2): the request sizes of traffic stream s, where the mix gives a
      list of ``samples_per_request``;
    - (6, j): a kind's own draws, such as its dense weights
      (``deploy/<kind>.py``; j chosen by the kind, from 1).

    The table rows are drawn apart from these, by a ``torch.Generator``
    seeded with ``seed_streams(seed)`` (``make_rows``); a kind that draws
    its weights on the card seeds its own from ``stream(seed, 6, j)``.
    """
    return np.random.default_rng([seed_streams(seed), *path])


@dataclasses.dataclass
class Layout:
    """How rows become keys. ``rows[t]``: table t's rows; ``mult``/``add``:
    its key hash."""

    rows: list
    mult: list
    add: list

    @classmethod
    def make(cls, rows, seed: int) -> "Layout":
        rng = stream(seed, 1)
        mult = [int(m) * 2 + 1 for m in rng.integers(0, 1 << (KEY_BITS - 1), len(rows))]
        add = [int(a) for a in rng.integers(0, 1 << KEY_BITS, len(rows))]
        return cls(list(rows), mult, add)

    def keys(self, t: int, rows: np.ndarray) -> np.ndarray:
        """Table t's keys of ``rows`` (int64)."""
        r = np.asarray(rows, np.uint64)
        with np.errstate(over="ignore"):
            h = (r * np.uint64(self.mult[t]) + np.uint64(self.add[t])) & np.uint64(_KEY_MASK)
        return (h | np.uint64(t << KEY_BITS)).astype(np.int64)

    @property
    def offsets(self) -> np.ndarray:
        """First row of each table in the tables' concatenation."""
        return np.concatenate([[0], np.cumsum(self.rows)[:-1]]).astype(np.int64)


def make_rows(total_rows: int, dim: int, seed: int, device) -> np.ndarray:
    """[total_rows, dim] float32 N(0, 1), drawn on ``device``, as numpy."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed_streams(seed))
    x = torch.randn((total_rows, dim), generator=g, device=device, dtype=torch.float32)
    out = x.cpu().numpy()
    del x
    return out

