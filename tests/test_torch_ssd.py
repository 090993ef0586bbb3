"""The port's SSD tier (tiers/ssd.py) against the JAX package's.

The on-disk format is shared byte for byte: the same inserts write the same
``data.log`` and ``meta.json``, and a directory written by either package
opens in the other with the same answers. The parameter server's SSD paths
(the resume from the persistent tier, the DRAM write-back of SSD hits, the
prefetch, the refresh of promoted DRAM rows on a reload) give the JAX
package's tier contents and answers.
"""

import shutil
import time

import numpy as np
import pytest

from hugectr_backend_tpu import HierParameterServer as JaxPS
from hugectr_backend_tpu import LookupSession as JaxSession
from hugectr_backend_tpu.config.params import PersistentDatabaseParams as JaxDbParams
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu.tiers.ssd import SsdKVTier as JaxSsd
from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
from hugectr_backend_tpu_torch.config.params import PersistentDatabaseParams
from hugectr_backend_tpu_torch.tiers.base import table_tag
from hugectr_backend_tpu_torch.tiers.ssd import SsdKVTier

DEADLINE_S = 10.0


def _tier(cls, params_cls, path):
    return cls(params_cls(path=str(path)))


def _ops(tier):
    """The JAX package's test_ssd_tier_roundtrip sequence plus a churn past
    the overlay thresholds; every answer returned."""
    keys = np.array([5, 9, 123456789], dtype=np.int64)
    vecs = np.arange(9, dtype=np.float32).reshape(3, 3)
    tier.insert("hps_et.m.t", keys, vecs)
    out = [tier.query("hps_et.m.t", np.array([9, 7, 5], dtype=np.int64))]
    tier.insert("hps_et.m.t", keys[:1], vecs[:1] + 100)
    rng = np.random.default_rng(40)
    big = rng.choice(10**8, 30_000, replace=False).astype(np.int64)
    for i in range(5):
        tier.insert("hps_et.m.t", big[i * 3000 : i * 3000 + 9000],
                    rng.standard_normal((9000, 3)).astype(np.float32))
    tier.evict("hps_et.m.t", big[:100])
    out.append(tier.query("hps_et.m.t", np.concatenate([keys, big[:300]])))
    out.append((np.sort(tier.keys("hps_et.m.t")), tier.size("hps_et.m.t")))
    return out


def _same(a, b):
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_ssd_tier_roundtrip(tmp_path):
    tier = _tier(SsdKVTier, PersistentDatabaseParams, tmp_path / "port")
    got = _ops(tier)
    (out, found) = got[0]
    assert found.tolist() == [True, False, True]
    np.testing.assert_array_equal(out[0], np.arange(3, 6, dtype=np.float32))
    tier2 = _tier(SsdKVTier, PersistentDatabaseParams, tmp_path / "port")
    out2, found2 = tier2.query("hps_et.m.t", np.array([5], np.int64))
    assert found2[0]
    np.testing.assert_array_equal(out2[0], np.arange(3, dtype=np.float32) + 100)
    tier2.compact()
    np.testing.assert_array_equal(tier2.query("hps_et.m.t", np.array([5], np.int64))[0][0],
                                  np.arange(3, dtype=np.float32) + 100)
    _same(got, _ops(_tier(JaxSsd, JaxDbParams, tmp_path / "jax")))


def test_ssd_files_identical_to_jax(tmp_path):
    """The same inserts write the same log and metadata bytes."""
    tp = _tier(SsdKVTier, PersistentDatabaseParams, tmp_path / "port")
    tj = _tier(JaxSsd, JaxDbParams, tmp_path / "jax")
    _ops(tp)
    _ops(tj)
    tp.close()
    tj.close()
    for name in ("data.log", "meta.json"):
        assert ((tmp_path / "port" / "hps_et.m.t" / name).read_bytes()
                == (tmp_path / "jax" / "hps_et.m.t" / name).read_bytes())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ssd_directory_opens_in_the_other_package(tmp_path, writer):
    """A directory one package wrote (log, sidecar index after a compaction,
    and a tail of records past the sidecar's watermark) opens in the other
    with the same answers."""
    classes = {"port": (SsdKVTier, PersistentDatabaseParams), "jax": (JaxSsd, JaxDbParams)}
    reader = "jax" if writer == "port" else "port"
    w = _tier(*classes[writer], tmp_path / "ssd")
    rng = np.random.default_rng(41)
    keys = rng.choice(10**9, 50_000, replace=False).astype(np.int64)
    w.insert("t", keys, rng.standard_normal((50_000, 8)).astype(np.float32))
    w.compact()  # writes the sidecar
    w.insert("t", keys[:5000], np.full((5000, 8), 3.5, np.float32))  # the tail
    probe = np.concatenate([keys[:6000], np.array([-7], np.int64)])
    want = w.query("t", probe)
    w.close()
    r = _tier(*classes[reader], tmp_path / "ssd")
    got = r.query("t", probe)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert r.size("t") == 50_000
    r.close()


def _cfg(tmp_path, name, **vdb):
    return {
        "volatile_db": {"type": "hash_map", **vdb},
        "persistent_db": {"type": "rocks_db", "path": str(tmp_path / f"ssd_{name}")},
        "models": [{"model": "m", "sparse_files": [str(tmp_path / "t0")],
                    "embedding_vecsize_per_table": [8],
                    "maxnum_catfeature_query_per_table_per_sample": [4],
                    "gpucacheper": 0.2, "embedding_cache_type": "dynamic",
                    "hit_rate_threshold": 1.0, "quant_bits": 32}],
    }


def test_resume_from_persistent_tier(tmp_path):
    """initialize_after_startup false: a restarted server serves from the SSD
    tier alone, here one the JAX package wrote, as the JAX package does."""
    tbl = make_synthetic_table(400, 8, seed=101)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    JaxPS.create(_cfg(tmp_path, "shared")).shutdown()
    shutil.rmtree(tmp_path / "t0")
    cfg = _cfg(tmp_path, "shared", initialize_after_startup=False)
    ps_j = JaxPS.create(cfg)
    ps_t = HierParameterServer.create(cfg, device="cpu")
    try:
        st = LookupSession.create(ps_t.get_model_params("m"), ps_t.get_embedding_cache("m", 0))
        sj = JaxSession.create(ps_j.get_model_params("m"), ps_j.get_embedding_cache("m", 0))
        for lo in (0, 100, 300):
            q = tbl.keys[lo : lo + 25]
            out = st.lookup_numpy([q])[0]
            np.testing.assert_array_equal(out, sj.lookup_numpy([q])[0])
            np.testing.assert_allclose(out, expected_vector(q, 8), rtol=1e-6)
    finally:
        ps_t.shutdown()
        ps_j.shutdown()


def _wait_dram(ps, tag, keys):
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        if ps.dram.query(tag, keys)[1].all():
            return True
        time.sleep(0.01)
    return False


def test_ssd_hits_written_back_and_prefetched_into_dram(tmp_path):
    """cache_missed_embeddings writes SSD hits back into DRAM, and prefetch
    promotes SSD rows into DRAM, off the request thread, in both packages."""
    tbl = make_synthetic_table(1000, 8, seed=42)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    tag = table_tag("m", "sparse_embedding0")
    for name, make in (("torch", lambda c: HierParameterServer.create(c, device="cpu")),
                       ("jax", JaxPS.create)):
        ps = make(_cfg(tmp_path, name, initial_cache_rate=0.1,
                       cache_missed_embeddings=True))
        try:
            outside = tbl.keys[~ps.dram.query(tag, tbl.keys)[1]]
            cold = outside[:10]
            vecs, found = ps._query_tiers(tag, cold)
            assert found.all()
            np.testing.assert_array_equal(vecs, expected_vector(cold, 8))
            assert _wait_dram(ps, tag, cold), name
            pre = outside[-50:]
            ps.prefetch("m", 0, pre)
            assert _wait_dram(ps, tag, pre), name
            np.testing.assert_array_equal(ps.dram.query(tag, pre)[0],
                                          expected_vector(pre, 8))
        finally:
            ps.shutdown()


def test_reload_refreshes_promoted_dram_rows(tmp_path):
    tbl = make_synthetic_table(100, 8, seed=41)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    tag = table_tag("m", "sparse_embedding0")
    k = tbl.keys[-1:]
    results = []
    for name, make in (("torch", lambda c: HierParameterServer.create(c, device="cpu")),
                       ("jax", JaxPS.create)):
        ps = make(_cfg(tmp_path, name, initial_cache_rate=0.1))
        try:
            ps.dram.insert(tag, k, np.full((1, 8), -7.0, np.float32))
            ps.update_database_per_model(ps.get_model_params("m"))
            vecs, found = ps.dram.query(tag, k)
            assert found.all()
            np.testing.assert_allclose(vecs, expected_vector(k, 8), rtol=1e-6)
            results.append((np.sort(ps.dram.keys(tag)), np.sort(ps.ssd.keys(tag))))
        finally:
            ps.shutdown()
    _same([results[0]], [results[1]])


def test_uvm_pins_the_whole_table_in_dram(tmp_path):
    tbl = make_synthetic_table(500, 8, seed=43)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    cfg = _cfg(tmp_path, "torch", initial_cache_rate=0.1)
    cfg["models"][0]["embedding_cache_type"] = "uvm"
    ps = HierParameterServer.create(cfg, device="cpu")
    try:
        tag = table_tag("m", "sparse_embedding0")
        assert ps.dram.size(tag) == ps.ssd.size(tag) == 500
    finally:
        ps.shutdown()
