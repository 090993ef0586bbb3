"""The port's device cache -> DRAM -> SSD hierarchy against the JAX package's.

Mirrors tests/test_tiering_config5.py (a table larger than the device cache
served through the three tiers, fp8 tables, the stats endpoint, the SSD's
sidecar index and compaction) and the tier cases of tests/test_robustness.py
(the SSD failing at run time, one server shared by several models, lookups
racing inserts and refreshes), then serves a dynamic deployment over HTTP
through both packages' front ends. Both packages run on the CPU with the same
ps.json and the same seeded keys; answers are compared bit for bit, except
under thread races, where each answer is held to the table's exact vector.
"""

import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from hugectr_backend_tpu import HierParameterServer as JaxPS
from hugectr_backend_tpu import LookupSession as JaxSession
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager
from hugectr_backend_tpu.serving.server import HpsHttpServer as JaxHttpServer
from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
from hugectr_backend_tpu_torch.serving import metrics as tmetrics
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager
from hugectr_backend_tpu_torch.serving.server import HpsHttpServer
from hugectr_backend_tpu_torch.tiers.ssd import SsdKVTier

TIMEOUT = 10


def _deploy(cfg_for):
    return (HierParameterServer.create(cfg_for("torch"), device="cpu"),
            JaxPS.create(cfg_for("jax")))


def _sessions(ps_t, ps_j, model):
    return (LookupSession.create(ps_t.get_model_params(model), ps_t.get_embedding_cache(model, 0)),
            JaxSession.create(ps_j.get_model_params(model), ps_j.get_embedding_cache(model, 0)))


def _lookup_both(st, sj, keys_per_table):
    a, b = st.lookup_numpy(keys_per_table), sj.lookup_numpy(keys_per_table)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, np.asarray(y))
    return a


def _model(name, files, dim, **kw):
    files = files if isinstance(files, list) else [files]
    m = {"model": name, "sparse_files": [str(f) for f in files],
         "embedding_vecsize_per_table": [dim] * len(files),
         "maxnum_catfeature_query_per_table_per_sample": [4] * len(files)}
    m.update(kw)
    return m


# ------------------------------------------------- tests/test_tiering_config5.py


def test_table_exceeding_cache_served_via_tiers(tmp_path):
    tbl = make_synthetic_table(5000, 16, seed=130)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "volatile_db": {"type": "parallel_hash_map", "initial_cache_rate": 0.3},
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [_model("huge", tmp_path / "t0", 16, gpucacheper=0.02,
                          embedding_cache_type="dynamic", hit_rate_threshold=0.5,
                          quant_bits=8, fp8_quant=False)]})
    try:
        tag = "hps_et.huge.sparse_embedding0"
        assert ps_t.dram.size(tag) == 1500 and ps_t.ssd.size(tag) == 5000
        st, sj = _sessions(ps_t, ps_j, "huge")
        assert st.cache.tables[0].capacity == 100
        rng = np.random.default_rng(0)
        for _ in range(5):
            q = tbl.keys[rng.integers(0, 5000, 200)]
            out = st.lookup_numpy([q])[0]
            sj.lookup_numpy([q])
            ref = expected_vector(q, 16)
            absmax = np.abs(ref).max(axis=1, keepdims=True)
            assert np.all(np.abs(out - ref) <= absmax / (2 * 127.0) + 1e-6)
        # Inserts above the 0.5 threshold run on each package's drainer:
        # once both are drained, the same keys are resident at the same slots.
        assert st.cache.drain_pending(TIMEOUT) and sj.cache.drain_pending(TIMEOUT)
        assert st.cache.slotmaps[0].size() == 100
        q = tbl.keys[rng.integers(0, 5000, 200)]
        st.cache.hit_meter.rates[0] = sj.cache.hit_meter.rates[0] = 0.0
        _lookup_both(st, sj, [q])
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def test_fp8_quantized_table_roundtrip(tmp_path):
    tbl = make_synthetic_table(500, 16, seed=131)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda _n: {"models": [_model(
        "f8", tmp_path / "t0", 16, gpucacheper=0.5, embedding_cache_type="dynamic",
        fp8_quant=True, hit_rate_threshold=1.0)]})
    try:
        st, sj = _sessions(ps_t, ps_j, "f8")
        assert "float8" in str(st.cache.tables[0].values.dtype)
        for lo in (0, 100, 300):
            out = _lookup_both(st, sj, [tbl.keys[lo : lo + 100]])[0]
            ref = expected_vector(tbl.keys[lo : lo + 100], 16)
            assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.07
        # The fp8 rows inserted by the misses above serve as the JAX package's.
        _lookup_both(st, sj, [tbl.keys[250:400]])
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def _stats_cfg(path):
    return json.dumps({"models": [_model(
        "s", path, 4, maxnum_catfeature_query_per_table_per_sample=[2], gpucacheper=0.5,
        embedding_cache_type="dynamic", quant_bits=32)]})


def test_stats_endpoint(tmp_path):
    tbl = make_synthetic_table(100, 4, seed=132)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    mgr = ModelManager.create(_stats_cfg(tmp_path / "t0"), device="cpu")
    server = HpsHttpServer(mgr, port=0).start()
    try:
        mgr.infer("s", tbl.keys[:2], [2])
        mgr.infer("s", tbl.keys[:4], [4])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/v2/models/s/stats", timeout=TIMEOUT) as r:
            stats = json.loads(r.read())["model_stats"][0]
        assert stats["inference_count"] >= 2
        assert stats["samples"] >= 3
        assert stats["latency_p50_s"] > 0
        # The same keys as the JAX package's stats.
        jmgr = JaxManager.create(_stats_cfg(tmp_path / "t0"))
        jsrv = JaxHttpServer(jmgr, port=0).start()
        try:
            jmgr.infer("s", tbl.keys[:2], [2])
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{jsrv.port}/v2/models/s/stats", timeout=TIMEOUT) as r:
                jstats = json.loads(r.read())["model_stats"][0]
        finally:
            jsrv.stop()
        assert set(stats) == set(jstats)
    finally:
        server.stop()


def test_ssd_scale_sidecar_and_background_compaction(tmp_path):
    dim, n = 16, 300_000
    rng = np.random.default_rng(0)
    keys = rng.choice(10**9, size=n, replace=False).astype(np.int64)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    tier = SsdKVTier(path=str(tmp_path / "ssd"), background_compaction=False)
    tier.insert("t", keys, vecs)
    upd = keys[1000:2000]
    tier.insert("t", upd, np.full((1000, dim), 7.5, np.float32))
    assert tier.size("t") == n
    tier.compact()
    tier.close()
    tier2 = SsdKVTier(path=str(tmp_path / "ssd"), background_compaction=False)
    probe = np.concatenate([keys[:500], upd[:500], np.array([-1], np.int64)])
    out, found = tier2.query("t", probe)
    assert found[:1000].all() and not found[1000]
    np.testing.assert_array_equal(out[:500], vecs[:500])
    np.testing.assert_array_equal(out[500:1000], 7.5)
    churn = keys[:60_000]
    for _ in range(6):
        tier2.insert("t", churn, rng.standard_normal((60_000, dim)).astype(np.float32))
    log = tier2._logs["t"]
    live, total = log.live_and_total()
    assert total > live
    before = (tmp_path / "ssd" / "t" / "data.log").stat().st_size
    while tier2.maybe_compact():
        pass
    assert log.live_and_total() == (n, n)
    assert (tmp_path / "ssd" / "t" / "data.log").stat().st_size < before
    assert tier2.query("t", keys[:100])[1].all()
    tier2.close()


# -------------------------------------------------- tests/test_robustness.py


def test_concurrent_lookup_insert_refresh(tmp_path):
    """Six sessions look up while a refresher runs and misses insert: every
    answer is the table's exact vector (no foreign row, no torn write)."""
    tbl = make_synthetic_table(2000, 8, seed=110)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps = HierParameterServer.create({"models": [_model(
        "c", tmp_path / "t0", 8, maxnum_catfeature_query_per_table_per_sample=[8],
        gpucacheper=0.25, embedding_cache_type="dynamic", hit_rate_threshold=0.8,
        quant_bits=32)]}, device="cpu")
    cache = ps.get_embedding_cache("c", 0)
    params = ps.get_model_params("c")
    errs, stop = [], threading.Event()

    def reader(seed):
        rng = np.random.default_rng(seed)
        sess = LookupSession.create(params, cache)
        try:
            for _ in range(30):
                q = tbl.keys[rng.integers(0, 2000, 64)]
                np.testing.assert_array_equal(sess.lookup_numpy([q])[0],
                                              expected_vector(q, 8))
        except Exception as e:  # reported below
            errs.append(e)

    def refresher():
        while not stop.is_set():
            cache.refresh(fraction=0.5)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(6)]
    rt = threading.Thread(target=refresher)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        rt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        stop.set()
        rt.join(timeout=TIMEOUT)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    alive = [t for t in threads + [rt] if t.is_alive()]
    assert cache.drain_pending(TIMEOUT)
    ps.shutdown()
    assert not alive and not errs, errs[:2]


def test_ssd_failure_served_from_dram(tmp_path):
    tbl = make_synthetic_table(300, 4, seed=111)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [_model("f", tmp_path / "t0", 4, gpucacheper=0.1,
                          embedding_cache_type="dynamic", quant_bits=32)]})
    try:
        ps_t.ssd = None  # DRAM only from here on
        ps_j.ssd = None
        st, sj = _sessions(ps_t, ps_j, "f")
        q = tbl.keys[200:260]
        out = _lookup_both(st, sj, [q])[0]
        np.testing.assert_allclose(out, expected_vector(q, 4), rtol=1e-6)
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def test_multi_model_shared_ps(tmp_path):
    t1 = make_synthetic_table(500, 8, seed=112)
    t2 = make_synthetic_table(700, 16, seed=113)
    write_sparse_model(tmp_path / "a0", t1.keys, t1.vectors)
    write_sparse_model(tmp_path / "b0", t2.keys, t2.vectors)
    ps_t, ps_j = _deploy(lambda n: {
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
        "models": [
            _model("alpha", tmp_path / "a0", 8, gpucacheper=1.0,
                   embedding_cache_type="static", quant_bits=32),
            _model("beta", tmp_path / "b0", 16, gpucacheper=0.3,
                   embedding_cache_type="dynamic", quant_bits=8, hit_rate_threshold=1.0),
        ]})
    try:
        assert set(ps_t.get_hps_model_configuration_map()) == {"alpha", "beta"}
        sa, saj = _sessions(ps_t, ps_j, "alpha")
        sb, sbj = _sessions(ps_t, ps_j, "beta")
        oa = _lookup_both(sa, saj, [t1.keys[:10]])[0]
        np.testing.assert_allclose(oa, expected_vector(t1.keys[:10], 8), rtol=1e-6)
        for lo in (0, 300, 600):
            ob = _lookup_both(sb, sbj, [t2.keys[lo : lo + 100]])[0]
            ref_b = expected_vector(t2.keys[lo : lo + 100], 16)
            assert np.abs(ob - ref_b).max() <= np.abs(ref_b).max() / (2 * 127) + 1e-6
        ps_t.destroy_embedding_cache_per_model("alpha")
        ps_j.destroy_embedding_cache_per_model("alpha")
        with pytest.raises(KeyError):
            ps_t.get_embedding_cache("alpha", 0)
        _lookup_both(sb, sbj, [t2.keys[:3]])
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


# --------------------------------------------------- the front end, dynamic


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.read()


def test_http_dynamic_deployment_matches_jax(tmp_path):
    """Requests to a dynamic deployment with synchronous inserts (a miss
    inserts before the next request translates) get the JAX package's bytes,
    and the misses count in the tier counters of /metrics."""
    tbls = [make_synthetic_table(n, 8, seed=140 + i) for i, n in enumerate([60, 400, 3000])]
    for i, t in enumerate(tbls):
        write_sparse_model(tmp_path / f"t{i}", t.keys, t.vectors)

    def cfg(n):
        return json.dumps({
            "volatile_db": {"type": "hash_map", "initial_cache_rate": 0.5},
            "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{n}")},
            "models": [_model("dyn", [tmp_path / f"t{i}" for i in range(3)], 8,
                              maxnum_catfeature_query_per_table_per_sample=[1, 1, 1],
                              gpucacheper=0.25, hit_rate_threshold=1.0, max_batch_size=16,
                              default_value_for_each_table=[0.0, 0.25, -1.0])]})

    tsrv = HpsHttpServer(ModelManager.create(cfg("torch"), device="cpu"), port=0).start()
    jsrv = JaxHttpServer(JaxManager.create(cfg("jax")), port=0).start()
    try:
        before = tmetrics.TIER_HIT.value(tier="ssd")
        rng = np.random.default_rng(141)
        for _ in range(6):
            keys = np.concatenate([t.keys[rng.integers(0, len(t.keys), 8)] for t in tbls])
            keys[[0, 9]] = 10**12  # absent from every tier
            body = json.dumps({"inputs": [
                {"name": "KEYS", "datatype": "INT64", "shape": [24],
                 "data": [int(k) for k in keys]},
                {"name": "NUMKEYS", "datatype": "INT32", "shape": [3], "data": [8, 8, 8]},
            ]}).encode()
            got = _post(tsrv.port, "/v2/models/dyn/infer", body)
            want = _post(jsrv.port, "/v2/models/dyn/infer", body)
            assert got == want
            assert got[0] == 200
        assert tmetrics.TIER_HIT.value(tier="ssd") > before
        with urllib.request.urlopen(f"http://127.0.0.1:{tsrv.port}/metrics",
                                    timeout=TIMEOUT) as r:
            text = r.read().decode()
        assert 'hps_tier_hit{tier="ssd"}' in text and 'hps_tier_miss{tier="dram"}' in text
    finally:
        tsrv.stop()
        jsrv.stop()


def test_chip_smoke_dynamic_tiers_rehearsal(tmp_path, monkeypatch):
    """chip_smoke's dynamic_tiers phase on the CPU at a small size (4 tables
    capped at 4,096 rows, D 16, batch 256): every step's checks run (the
    "card" instance is a second CPU instance, and K1 is not launched)."""
    import torch

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "ROW_CAP", 4096)
    monkeypatch.setattr(cs, "DIM", 16)
    monkeypatch.setattr(cs, "BOTTOM", (64, 32, 16))
    monkeypatch.setattr(cs, "TOP", (64, 32, 1))
    cards = [min(c, cs.ROW_CAP) for c in cs.CRITEO_CARDS[:4]]
    tables, _ = cs.build_deployment(str(tmp_path), cards, cs.DIM, cs.SEED)
    lines = []
    out = cs.dynamic_tiers(torch.device("cpu"), str(tmp_path), tables, batch=256,
                           emit_line=lines.append)
    assert len(out["sync"]) == cs.DYN_SYNC_BATCHES
    assert all(r["k1_launches"] == 0 for r in out["sync"])
    assert out["sync"][0]["rows_written"] > 0 and out["async"]["drained"]
    assert out["uvm"]["admitted"] > 0 and out["fold"]["bit_identical"]
    assert out["fold"]["keys_at_other_slots"] > 0 and out["launches"] == {}
    assert out["update"]["keys_per_table"] == [4096, 4096, 1460, 583]
    assert {line["dynamic_tiers"] for line in lines} == {
        "deploy", "sync", "async", "stochastic", "uvm", "fold", "update"}
