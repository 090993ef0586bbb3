"""The port's dynamic, stochastic and UVM caches against the JAX package's.

Each case of tests/test_dynamic_cache.py runs here on both packages with the
same ps.json, the same seeded keys and vectors and the same call sequence:
the port on the CPU (plain versions), the JAX package on the CPU. Answers are
bit-identical and so are the resident key -> slot maps, where the sequence is
deterministic (synchronous inserts); after an asynchronous insert both are
drained first. Both slot maps of the port are held against the JAX package's.
"""

import threading
import time

import numpy as np
import pytest

from hugectr_backend_tpu import HierParameterServer as JaxPS
from hugectr_backend_tpu import LookupSession as JaxSession
from hugectr_backend_tpu.cache import slotmap as jax_slotmap
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
from hugectr_backend_tpu_torch.cache.embedding_cache import (
    DynamicEmbeddingCache,
    UvmEmbeddingCache,
)
from hugectr_backend_tpu_torch.cache.slotmap import NativeSlotMap, PySlotMap
from hugectr_backend_tpu_torch.tiers.base import table_tag

KEMPTY = np.iinfo(np.int64).min
DEADLINE_S = 10.0


def _deploy(cfg_for):
    """Both packages' servers for ``cfg_for(name)`` (name keeps their SSD
    directories apart). -> (port, jax)."""
    return (HierParameterServer.create(cfg_for("torch"), device="cpu"),
            JaxPS.create(cfg_for("jax")))


def _sessions(ps_t, ps_j, model):
    return (LookupSession.create(ps_t.get_model_params(model), ps_t.get_embedding_cache(model, 0)),
            JaxSession.create(ps_j.get_model_params(model), ps_j.get_embedding_cache(model, 0)))


def _lookup_both(st, sj, keys_per_table):
    """Both sessions' answers; they must be bit-identical. -> the port's."""
    a, b = st.lookup_numpy(keys_per_table), sj.lookup_numpy(keys_per_table)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, np.asarray(y))
    return a


def _resident(cache, t=0):
    keys, slots = cache.slotmaps[t].resident()
    order = np.argsort(keys)
    return keys[order], slots[order]


def _same_resident(ct, cj):
    for t in range(len(ct.slotmaps)):
        kt, st = _resident(ct, t)
        kj, sj = _resident(cj, t)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(st, sj)


def _model(name, path, dim, **kw):
    m = {"model": name, "sparse_files": [str(path)], "embedding_vecsize_per_table": [dim],
         "maxnum_catfeature_query_per_table_per_sample": [4]}
    m.update(kw)
    return m


# ------------------------------------------------------------------ slot maps


def _slotmap_sequence(sm):
    """tests/test_dynamic_cache.py::test_slotmap_semantics's sequence; every
    result returned."""
    out = [sm.translate(np.array([1, 2], np.int64))]
    out += list(sm.acquire(np.array([10, 20, 30], np.int64)))
    out.append(sm.translate(np.array([20, 99], np.int64)))
    sm.translate(np.array([20, 30], np.int64))
    out += list(sm.acquire(np.array([40, 50], np.int64)))
    out.append(np.array([sm.size()]))
    out += list(sm.resident())
    out += list(sm.acquire(np.array([20], np.int64)))
    return out


@pytest.mark.parametrize("cls", [PySlotMap, NativeSlotMap])
def test_slotmap_semantics(cls):
    sm = cls(4)
    got = _slotmap_sequence(sm)
    assert got[0].tolist() == [4, 4]
    assert sorted(got[1].tolist()) == [0, 1, 2] and (got[2] == KEMPTY).all()
    assert got[3][0] == got[1][1] and got[3][1] == 4
    assert 10 in got[5].tolist()  # the LRU victim was key 10
    assert got[6][0] == 4
    assert set(got[7].tolist()) <= {20, 30, 40, 50}
    assert (got[10] == KEMPTY).all()
    want = _slotmap_sequence(jax_slotmap.NativeSlotMap(4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls, capacity, key_space, steps", [
    (PySlotMap, 64, 300, 60),
    (NativeSlotMap, 64, 300, 60),
    (NativeSlotMap, 1000, 3000, 400),
    (NativeSlotMap, 7, 10, 300),
])
def test_slotmap_random_sequence_matches_jax(cls, capacity, key_space, steps):
    """A seeded storm of translate / acquire calls gives the JAX package's
    native map's slots, evictions and resident set at every step (the port's
    map finds its LRU victim through a heap, the JAX package's by a scan:
    ties in last use go to the lowest slot in both)."""
    rng = np.random.default_rng(31 + capacity)
    port, ref = cls(capacity), jax_slotmap.NativeSlotMap(capacity)
    for _ in range(steps):
        keys = rng.integers(0, key_space, int(rng.integers(1, 40))).astype(np.int64)
        if rng.random() < 0.5:
            touch = bool(rng.random() < 0.7)
            np.testing.assert_array_equal(port.translate(keys, touch=touch),
                                          ref.translate(keys, touch=touch))
        else:
            for a, b in zip(port.acquire(keys), ref.acquire(keys)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(port.resident(), ref.resident()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls", [PySlotMap, NativeSlotMap])
def test_slotmap_zero_capacity_is_safe(cls):
    sm = cls(0)
    slots, ev = sm.acquire(np.array([1, 2, 3], np.int64))
    assert (slots == -1).all() and (ev == KEMPTY).all()
    assert sm.size() == 0
    assert sm.translate(np.array([1], np.int64))[0] == sm.miss_slot
    ref_slots, ref_ev = jax_slotmap.NativeSlotMap(0).acquire(np.array([1, 2, 3], np.int64))
    np.testing.assert_array_equal(slots, ref_slots)
    np.testing.assert_array_equal(ev, ref_ev)


# ---------------------------------------------------------------- dynamic cache


@pytest.fixture
def dynamic_pair(tmp_path):
    tbl = make_synthetic_table(1000, 8, seed=91)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    cfg = lambda _n: {"models": [_model(  # noqa: E731
        "dyn", tmp_path / "t0", 8, gpucacheper=0.2, embedding_cache_type="dynamic",
        hit_rate_threshold=0.9, quant_bits=32)]}
    ps_t, ps_j = _deploy(cfg)
    yield ps_t, ps_j, tbl
    ps_t.shutdown()
    ps_j.shutdown()


def test_dynamic_insert_on_miss(dynamic_pair):
    ps_t, ps_j, tbl = dynamic_pair
    st, sj = _sessions(ps_t, ps_j, "dyn")
    ct, cj = st.cache, sj.cache
    assert isinstance(ct, DynamicEmbeddingCache)
    resident, _ = ct.slotmaps[0].resident()
    _lookup_both(st, sj, [resident[:64]])
    assert ct.hit_meter.rate(0) > 0.9
    cold = tbl.keys[500:501]
    assert ct.translate(0, cold)[0] == ct.slotmaps[0].miss_slot
    out = _lookup_both(st, sj, [cold])[0]
    np.testing.assert_allclose(out, expected_vector(cold, 8), rtol=1e-6)
    # Above the threshold: the drainer inserts.
    assert ct.drain_pending(DEADLINE_S) and cj.drain_pending(DEADLINE_S)
    assert ct.translate(0, cold)[0] != ct.slotmaps[0].miss_slot
    _same_resident(ct, cj)
    out2 = _lookup_both(st, sj, [cold])[0]
    np.testing.assert_allclose(out2, expected_vector(cold, 8), rtol=1e-6)


def test_dynamic_capacity_bounded(dynamic_pair):
    ps_t, ps_j, tbl = dynamic_pair
    st, sj = _sessions(ps_t, ps_j, "dyn")
    st.cache.hit_meter.rates[0] = 0.0
    sj.cache.hit_meter.rates[0] = 0.0
    for i in range(0, 1000, 100):
        _lookup_both(st, sj, [tbl.keys[i : i + 100]])
        _same_resident(st.cache, sj.cache)
    assert st.cache.slotmaps[0].size() == 200
    q = tbl.keys[np.random.default_rng(0).integers(0, 1000, 64)]
    out = _lookup_both(st, sj, [q])[0]
    np.testing.assert_allclose(out, expected_vector(q, 8), rtol=1e-6)


def test_sync_insert_below_threshold(dynamic_pair):
    ps_t, ps_j, tbl = dynamic_pair
    st, sj = _sessions(ps_t, ps_j, "dyn")
    st.cache.hit_meter.rates[0] = 0.0
    sj.cache.hit_meter.rates[0] = 0.0
    cold = tbl.keys[900:902]
    _lookup_both(st, sj, [cold])
    assert (st.cache.translate(0, cold) != st.cache.slotmaps[0].miss_slot).all()
    _same_resident(st.cache, sj.cache)


def test_cold_cache_first_miss_inserts_sync(dynamic_pair):
    ps_t, ps_j, tbl = dynamic_pair
    st, sj = _sessions(ps_t, ps_j, "dyn")
    assert st.cache.hit_meter.rate(0) == 0.0
    resident, _ = st.cache.slotmaps[0].resident()
    cold = np.setdiff1d(tbl.keys, resident)[:8]
    _lookup_both(st, sj, [cold])
    assert (st.cache.translate(0, cold) != st.cache.slotmaps[0].miss_slot).all()
    _same_resident(st.cache, sj.cache)


def test_stochastic_cache_samples_inserts(tmp_path):
    """The same default_rng(0) stream picks the same keys as the JAX package."""
    tbl = make_synthetic_table(400, 4, seed=92)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda _n: {"models": [_model(
        "st", tmp_path / "t0", 4, gpucacheper=0.25, embedding_cache_type="stochastic",
        quant_bits=32)]})
    try:
        st, sj = _sessions(ps_t, ps_j, "st")
        st.cache.hit_meter.rates[0] = 0.0
        sj.cache.hit_meter.rates[0] = 0.0
        cold = tbl.keys[200:400]
        _lookup_both(st, sj, [cold])
        resident = (st.cache.translate(0, cold) != st.cache.slotmaps[0].miss_slot).sum()
        assert 0 < resident <= 100
        _same_resident(st.cache, sj.cache)
        out = _lookup_both(st, sj, [cold[:50]])[0]
        np.testing.assert_allclose(out, expected_vector(cold[:50], 4), rtol=1e-6)
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def _tiered_cfg(tmp_path, cache_type, init_rate=0.1):
    def cfg(name):
        return {
            "volatile_db": {"type": "hash_map", "initial_cache_rate": init_rate},
            "persistent_db": {"type": "rocks_db",
                              "path": str(tmp_path / f"ssd_{cache_type}_{name}")},
            "models": [_model("u", tmp_path / f"t_{cache_type}", 8, gpucacheper=0.25,
                              embedding_cache_type=cache_type, hit_rate_threshold=0.0,
                              quant_bits=32)],
        }
    return cfg


def test_uvm_distinct_from_dynamic(tmp_path):
    tbl = make_synthetic_table(1000, 8, seed=55)
    for ct in ("uvm", "dynamic"):
        write_sparse_model(tmp_path / f"t_{ct}", tbl.keys, tbl.vectors)
    uvm_t, uvm_j = _deploy(_tiered_cfg(tmp_path, "uvm"))
    dyn_t, dyn_j = _deploy(_tiered_cfg(tmp_path, "dynamic"))
    try:
        cu, cuj = uvm_t.get_embedding_cache("u", 0), uvm_j.get_embedding_cache("u", 0)
        cd, cdj = dyn_t.get_embedding_cache("u", 0), dyn_j.get_embedding_cache("u", 0)
        assert isinstance(cu, UvmEmbeddingCache)
        assert isinstance(cd, DynamicEmbeddingCache) and not isinstance(cd, UvmEmbeddingCache)
        tag = table_tag("u", "sparse_embedding0")
        assert uvm_t.dram.query(tag, tbl.keys)[1].all()
        assert dyn_t.dram.query(tag, tbl.keys)[1].sum() < tbl.keys.shape[0]
        _same_resident(cu, cuj)
        non_res = np.setdiff1d(tbl.keys, _resident(cu)[0])[:16]
        su, suj = _sessions(uvm_t, uvm_j, "u")
        want = expected_vector(non_res, 8)
        np.testing.assert_allclose(_lookup_both(su, suj, [non_res])[0], want, atol=1e-5)
        assert cu.pending_admissions(0) == cuj.pending_admissions(0) > 0
        assert (cu.slotmaps[0].translate(non_res, touch=False)
                == cu.tables[0].index.miss_slot).any()
        sd, sdj = _sessions(dyn_t, dyn_j, "u")
        non_res_d = np.setdiff1d(tbl.keys, _resident(cd)[0])[:16]
        _lookup_both(sd, sdj, [non_res_d])
        assert cd.drain_pending(DEADLINE_S) and cdj.drain_pending(DEADLINE_S)
        assert (cd.slotmaps[0].translate(non_res_d, touch=False)
                != cd.tables[0].index.miss_slot).all()
        _same_resident(cd, cdj)
        # refresh admits the hot missed keys.
        assert cu.refresh(fraction=1.0) == cuj.refresh(fraction=1.0)
        assert (cu.slotmaps[0].translate(non_res, touch=False)
                != cu.tables[0].index.miss_slot).all()
        _same_resident(cu, cuj)
        np.testing.assert_allclose(_lookup_both(su, suj, [non_res])[0], want, atol=1e-5)
    finally:
        for ps in (uvm_t, uvm_j, dyn_t, dyn_j):
            ps.shutdown()


def test_zero_gpucacheper_dynamic_serves_from_tiers(tmp_path):
    tbl = make_synthetic_table(300, 8, seed=7)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda _n: {"models": [_model(
        "z", tmp_path / "t0", 8, gpucache=True, gpucacheper=0.0,
        embedding_cache_type="dynamic", quant_bits=32, hit_rate_threshold=1.1)]})
    try:
        st, sj = _sessions(ps_t, ps_j, "z")
        q = tbl.keys[[1, 5, 9]]
        for _ in range(3):
            out = _lookup_both(st, sj, [q])[0]
            np.testing.assert_allclose(out, expected_vector(q, 8), rtol=1e-6)
        _same_resident(st.cache, sj.cache)
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def test_dynamic_capacity_sized_from_table_rows(tmp_path):
    tbl = make_synthetic_table(1000, 8, seed=13)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "volatile_db": {"type": "hash_map", "initial_cache_rate": 0.1},
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [_model("cap", tmp_path / "t0", 8, gpucache=True, gpucacheper=0.5,
                          embedding_cache_type="dynamic", quant_bits=32)]})
    try:
        st, sj = _sessions(ps_t, ps_j, "cap")
        assert st.cache.tables[0].capacity == sj.cache.tables[0].capacity == 500
        _same_resident(st.cache, sj.cache)
        q = tbl.keys[[500, 600, 700]]
        out = _lookup_both(st, sj, [q])[0]
        np.testing.assert_allclose(out, expected_vector(q, 8), rtol=1e-6)
        assert (st.cache.slotmaps[0].translate(q, touch=False) >= 0).all()
        _same_resident(st.cache, sj.cache)
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def test_destroy_cache_stops_worker_threads(tmp_path):
    """Unloading a model stops its drainer; the thread count comes back."""
    tbl = make_synthetic_table(200, 8, seed=3)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    before = threading.active_count()
    ps = HierParameterServer.create({"models": [_model(
        "d", tmp_path / "t0", 8, gpucache=True, gpucacheper=0.5,
        embedding_cache_type="dynamic", quant_bits=32, hit_rate_threshold=0.0)]},
        device="cpu")
    cache = ps.get_embedding_cache("d", 0)
    sess = LookupSession.create(ps.get_model_params("d"), cache)
    sess.lookup_numpy([tbl.keys[[190, 191]]])  # miss -> async insert
    deadline = time.monotonic() + DEADLINE_S
    while not cache._drainer_started and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cache._drainer.is_alive()
    cache.refresh(fraction=1.0)  # starts the refresh pool too
    ps.destroy_embedding_cache_per_model("d")
    cache._drainer.join(timeout=DEADLINE_S)
    assert not cache._drainer.is_alive()
    ps.shutdown()
    deadline = time.monotonic() + DEADLINE_S
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_reload_evicts_stale_keys(tmp_path):
    tbl = make_synthetic_table(400, 8, seed=5)
    write_sparse_model(tmp_path / "v1", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [_model("m", tmp_path / "v1", 8, gpucache=True, gpucacheper=1.0,
                          embedding_cache_type="dynamic", quant_bits=32)]})
    try:
        tag = table_tag("m", "sparse_embedding0")
        dropped = tbl.keys[300:]
        write_sparse_model(tmp_path / "v2", tbl.keys[:300], tbl.vectors[:300])
        for ps in (ps_t, ps_j):
            params = ps.get_model_params("m")
            params.sparse_files = [str(tmp_path / "v2")]
            ps.update_database_per_model(params)
            assert not ps.dram.query(tag, dropped)[1].any()
            assert not ps.ssd.query(tag, dropped)[1].any()
            assert ps.dram.query(tag, tbl.keys[:10])[1].all()
        # The DRAM and SSD tiers hold the same keys in both packages.
        for tier in ("dram", "ssd"):
            np.testing.assert_array_equal(np.sort(getattr(ps_t, tier).keys(tag)),
                                          np.sort(getattr(ps_j, tier).keys(tag)))
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def test_dynamic_int8_arena_member_misses_hit_its_default_row(tmp_path):
    """Quantized arena members of a dynamic cache: misses and absent keys read
    each member's own default row (slot == capacity), inserts land inside the
    member, and every answer is the JAX package's."""
    tbls = [make_synthetic_table(n, 16, seed=60 + i) for i, n in enumerate([300, 900, 5000])]
    for i, t in enumerate(tbls):
        write_sparse_model(tmp_path / f"t{i}", t.keys, t.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "volatile_db": {"type": "hash_map", "initial_cache_rate": 0.5},
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [{"model": "a", "sparse_files": [str(tmp_path / f"t{i}") for i in range(3)],
                    "embedding_vecsize_per_table": [16] * 3,
                    "maxnum_catfeature_query_per_table_per_sample": [1] * 3,
                    "gpucacheper": 0.3, "hit_rate_threshold": 1.0,
                    "default_value_for_each_table": [0.5, -1.0, 2.0]}]})
    try:
        st, sj = _sessions(ps_t, ps_j, "a")
        kinds = {getattr(t, "arena", None) and t.arena.lookup_kind for t in st.cache.tables}
        assert "onehot" in kinds
        rng = np.random.default_rng(61)
        for _ in range(6):
            q = [t.keys[rng.integers(0, len(t.keys), 96)] for t in tbls]
            for k in q:
                k[:2] = 10**12 + rng.integers(0, 10, 2)  # absent everywhere
            out = _lookup_both(st, sj, q)
            for k, o, dv in zip(q, out, [0.5, -1.0, 2.0]):
                np.testing.assert_array_equal(o[:2], np.full((2, 16), dv, np.float32))
            _same_resident(st.cache, sj.cache)
            for t, tb in enumerate(st.cache.tables):
                _, slots = st.cache.slotmaps[t].resident()
                assert slots.max() < tb.capacity
    finally:
        ps_t.shutdown()
        ps_j.shutdown()
