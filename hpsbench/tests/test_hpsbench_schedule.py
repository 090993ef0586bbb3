"""The open-loop schedule and its lateness accounting; the closed loop's order."""

import numpy as np

from hpsbench import stats, tables
from hpsbench.traffic import Generator

MIX = {"loop": "open", "rate_rps": 37.0, "samples_per_request": 4, "zipf_exponent": 1.05,
       "absent_share": 0.1}


def layout(seed=1):
    return tables.Layout.make([10, 3, 1000], seed)


def test_open_schedule_same_work_every_seed():
    counts, firsts, gaps = set(), set(), []
    for seed in (0, 1, 2**31 + 5):
        reqs, sched, order = Generator(MIX, layout(seed), False, seed).requests(2.5)
        assert np.array_equal(order, np.arange(len(reqs)))
        counts.add(len(reqs))
        firsts.add(float(sched[0]))
        assert len(sched) == len(reqs) == round(37.0 * 2.5)
        assert np.all(np.diff(sched) >= 0) and sched[0] > 0 and sched[-1] < 2.5
        assert all(r.samples == 4 and len(r.rows) == 3 for r in reqs)
        gaps.append(np.sort(np.diff(np.concatenate([[0.0], sched]))))
    assert counts == {92} and len(firsts) == 3
    # the same set of gaps, in another order
    assert np.allclose(gaps[0], gaps[1]) and np.allclose(gaps[0], gaps[2])
    # exponential: the median gap is ln 2 times the mean
    assert abs(np.median(gaps[0]) / np.mean(gaps[0]) - np.log(2)) < 0.02


def test_same_seed_same_requests():
    a, sa, _ = Generator(MIX, layout(), False, 9).requests(1.0)
    b, sb, _ = Generator(MIX, layout(), False, 9).requests(1.0)
    assert np.array_equal(sa, sb)
    assert all(np.array_equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra.keys, rb.keys))


def test_rows_keys_and_absent_keys():
    lay = layout()
    reqs, _, _ = Generator(dict(MIX, rate_rps=400.0), lay, False, 3).requests(1.0)
    for r in reqs:
        for t, (rows, keys) in enumerate(zip(r.rows, r.keys)):
            assert np.all(rows < lay.rows[t])
            assert np.array_equal(keys[rows >= 0], lay.keys(t, rows[rows >= 0]))
            assert np.all(keys[rows < 0] < 0)
    absent = np.mean([np.mean(x < 0) for r in reqs for x in r.rows])
    assert 0.05 < absent < 0.15


def test_zipf_truncated_to_rows():
    lay = tables.Layout.make([1000], 0)
    (r,) = Generator(dict(MIX, absent_share=0.0), lay, False, 0).batch(1, 200_000)
    counts = np.bincount(r.rows[0], minlength=1000)
    # rank 1 against rank 2 against rank 10: k ** -1.05
    assert abs(counts[0] / counts[1] - 2 ** 1.05) < 0.1
    assert abs(counts[0] / counts[9] - 10 ** 1.05) < 1.5


def test_one_key_space_is_sample_major():
    lay = layout()
    (r,) = Generator(dict(MIX, absent_share=0.0), lay, True, 4).batch(1, 5)
    (rows,), (keys,) = r.rows, r.keys
    assert rows.shape == keys.shape == (15,)
    for s in range(5):
        for t in range(3):
            g = rows[s * 3 + t] - lay.offsets[t]
            assert 0 <= g < lay.rows[t]
            assert keys[s * 3 + t] == lay.keys(t, np.array([g]))[0]


def test_keys_unique_within_and_across_tables():
    lay = tables.Layout.make([5000, 5000], 11)
    k = np.concatenate([lay.keys(t, np.arange(5000)) for t in range(2)])
    assert np.unique(k).size == k.size and k.min() >= 0


def test_closed_order_cycles_the_pool():
    mix = {"loop": "closed", "pool": 5, "samples_per_request": 2, "zipf_exponent": 1.05}
    g = Generator(mix, layout(), False, 2)
    reqs, sched, _ = g.requests(1.0)
    assert len(reqs) == 5 and sched is None
    order = g.order(12)
    assert sorted(order[:5]) == list(range(5)) and sorted(order[5:10]) == list(range(5))


def test_open_loop_with_a_pool():
    mix = dict(MIX, pool=6)
    reqs, sched, order = Generator(mix, layout(), False, 2).requests(2.0)
    assert len(reqs) == 6 and len(sched) == len(order) == 74
    assert set(order.tolist()) == set(range(6))


def test_lateness_accounting():
    due = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    sent = due + np.array([0.0, 0.001, 0.0, 0.002, 0.01, 0.02, 0.03, 0.04])
    late = stats.lateness(due, sent)
    assert abs(late["max_s"] - 0.04) < 1e-12
    # the last quarter's median (0.035) minus the first's (0.0005)
    assert abs(late["growth_s"] - 0.0345) < 1e-12
