"""What a configuration or a mix may declare beyond one key a table and one
size: multi-hot bags (``keys_per_table_per_sample`` as a list), drawn
request sizes (``samples_per_request`` as a list) and per-sample dense
features (``num_dense``), as the generator draws them and the HPS kind
encodes, writes, warms up and judges them."""

import json

import numpy as np
import pytest

from hpsbench import tables
from hpsbench.deploy import hps
from hpsbench.metrics import k1_roofline
from hpsbench.reference.hps import HpsReference
from hpsbench.traffic import Generator, Request

ROWS = [50, 7, 400, 3]
MIX = {"loop": "closed", "clients": 4, "pool": 40, "samples_per_request": 6,
       "zipf_exponent": 1.05, "absent_share": 0.1}


def layout(seed=5):
    return tables.Layout.make(ROWS, seed)


def gen(seed=5, stream=2, mix=MIX, **kw):
    return Generator(mix, layout(seed), False, seed, stream, **kw)


def _same(a, b):
    assert a.samples == b.samples
    for x, y in zip(a.rows + a.keys, b.rows + b.keys):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# multi-hot bags

def test_bags_per_table():
    hot = [1, 4, 2, 3]
    reqs = gen(hotness=hot).batch(5, 6)
    vecs = tables.make_rows(sum(ROWS), 8, 5, "cpu")
    off = np.concatenate([[0], np.cumsum(ROWS)])
    ref = HpsReference([vecs[a:b] for a, b in zip(off[:-1], off[1:])], 8)
    for r in reqs:
        assert [x.size for x in r.rows] == [x.size for x in r.keys] == [6 * k for k in hot]
        hdr, raw = hps.encode({}, r)
        head = json.loads(hdr)["inputs"]
        assert [i["shape"] for i in head] == [[6 * sum(hot)], [4]]
        numkeys = np.frombuffer(raw[-16:], "<i4")
        assert numkeys.tolist() == [6 * k for k in hot]
        assert ref.response(r.rows).size == 6 * sum(hot) * 8


def test_k1_bytes_of_a_bag_by_hand():
    """Two samples, bags of 2 and 1: each distinct row (and the table's
    default row) read once at 8 + 4 B, each key's 8 floats written."""
    r = Request(2, [np.array([3, 3, 5, -1]), np.array([0, 0])], [None, None])
    assert k1_roofline.request_bytes(r, 8) == (3 * 12 + 4 * 32) + (1 * 12 + 2 * 32)


def test_bag_keys_are_sample_major():
    """Sample j's bag in table t is rows[t][j*k_t : (j+1)*k_t]: the keys
    sent are those rows' keys, in that order."""
    lay = layout()
    g = Generator(dict(MIX, absent_share=0.0), lay, False, 5, hotness=[2, 1, 3, 1])
    (r,) = g.batch(1, 4)
    for t, (rows, keys) in enumerate(zip(r.rows, r.keys)):
        assert np.array_equal(keys, lay.keys(t, rows))


def test_a_list_of_ones_draws_what_one_draws():
    for seed in (0, 5, 2**31 + 9):
        a = gen(seed).batch(7, 6)
        b = gen(seed, hotness=[1, 1, 1, 1]).batch(7, 6)
        for x, y in zip(a, b):
            _same(x, y)


def test_hotness_checked():
    with pytest.raises(ValueError):
        gen(hotness=[1, 2])
    with pytest.raises(ValueError):
        gen(hotness=[1, 0, 1, 1])
    with pytest.raises(ValueError):
        Generator(MIX, layout(), True, 5, hotness=[1, 2, 1, 1])


def test_ps_json_takes_the_list(tmp_path):
    cfg = {"model": "m", "embedding_dim": 4, "keys_per_table_per_sample": [1, 4, 2, 3],
           "max_batch_size": 64, "gpucacheper": 1.0, "embedding_cache_type": "static",
           "quant_bits": 8, "deployed_device_list": [0], "default_value": 0.0,
           "num_of_worker_buffer_in_pool": 2, "max_queue_delay_us": 300}
    lay = layout()
    path = hps.write(cfg, lay, np.zeros((sum(ROWS), 4), np.float32), str(tmp_path), 11)
    model = json.loads(open(path).read())["models"][0]
    assert model["maxnum_catfeature_query_per_table_per_sample"] == [1, 4, 2, 3]
    path = hps.write(dict(cfg, keys_per_table_per_sample=1), lay,
                     np.zeros((sum(ROWS), 4), np.float32), str(tmp_path), 11)
    model = json.loads(open(path).read())["models"][0]
    assert model["maxnum_catfeature_query_per_table_per_sample"] == [1, 1, 1, 1]


# drawn request sizes

SIZES = [100, 250, 700]


def test_sizes_come_from_the_list_and_repeat_per_seed():
    mix = dict(MIX, samples_per_request=SIZES)
    reqs, _, _ = gen(5, mix=mix).requests(0.1)
    again, _, _ = gen(5, mix=mix).requests(0.1)
    other, _, _ = gen(6, mix=mix).requests(0.1)
    sizes = [r.samples for r in reqs]
    assert set(sizes) == set(SIZES) and len(sizes) == 40
    assert sizes == [r.samples for r in again]
    assert sizes != [r.samples for r in other]
    for a, b in zip(reqs, again):
        _same(a, b)
    for r in reqs:
        assert [x.size for x in r.rows] == [r.samples] * 4


def test_one_size_takes_no_size_draw():
    """The int path draws its keys as it did: a list of one size draws the
    same rows (the sizes come from a stream of their own)."""
    a, _, _ = gen(5).requests(0.1)
    b, _, _ = gen(5, mix=dict(MIX, samples_per_request=[6])).requests(0.1)
    for x, y in zip(a, b):
        _same(x, y)


def test_warm_sizes_cover_every_bucket_to_the_cap():
    cfg = {"max_batch_size": 4096}
    mix = dict(MIX, samples_per_request=SIZES)
    sizes = hps.warm_sizes(cfg, mix)
    assert sizes == [100, 128, 256, 512, 1024, 2048, 2800]
    # every bucket a merge of 100 .. 2800 samples pads to is warmed
    buckets = {1 << (n - 1).bit_length() for n in range(100, 2801)}
    assert buckets == {1 << (s - 1).bit_length() for s in sizes}
    assert hps.warm_sizes({"max_batch_size": 1000}, mix)[-1] == 1000
    assert hps.warm_sizes(cfg, dict(MIX, samples_per_request=64, clients=16)) == [
        64, 128, 256, 512, 1024]


# dense features

def test_dense_repeats_per_seed_and_moves_no_key():
    plain = gen(5).batch(4, 6)
    a = gen(5, num_dense=13).batch(4, 6)
    b = gen(5, num_dense=13).batch(4, 6)
    c = gen(6, num_dense=13).batch(4, 6)
    assert all(r.dense is None for r in plain)
    for p, x, y, z in zip(plain, a, b, c):
        _same(p, x)
        assert x.dense.shape == (6, 13) and x.dense.dtype == np.float32
        assert np.array_equal(x.dense, y.dense) and not np.array_equal(x.dense, z.dense)
        k = np.expm1(x.dense.astype(np.float64))
        assert np.allclose(k, np.rint(k), atol=1e-3 * (1 + k))
        assert 0 <= k.min() and k.max() < 65536.5


def test_dense_is_heavy_tailed():
    (r,) = gen(5, num_dense=13).batch(1, 4000)
    k = np.rint(np.expm1(r.dense.astype(np.float64)))
    # Zipf(1.2) over 65,536 values: P(0) = 1 / sum(r**-1.2) = 0.198, and
    # some of 52,000 draws reach the thousands
    assert 0.18 < np.mean(k == 0) < 0.22 and k.max() > 1000


def test_dense_with_drawn_sizes_and_warm_streams():
    mix = dict(MIX, samples_per_request=SIZES)
    reqs, _, _ = gen(5, mix=mix, num_dense=2).requests(0.1)
    assert all(r.dense.shape == (r.samples, 2) for r in reqs)
    warm, _, _ = gen(5, stream=5, mix=mix, num_dense=2).requests(0.1)
    assert [r.samples for r in reqs] != [r.samples for r in warm]
    assert not np.array_equal(reqs[0].dense[:3], warm[0].dense[:3])
