"""The port's native host library (its own copy of ``kvstore.cpp`` and
``shm_kvstore.cpp``, built at first use into ``hugectr_backend_tpu_torch/
_build/``) against the JAX package, on the same seeded inputs.

Tolerance: none. Key -> slot translation, the DRAM stores' answers, the
int8/int4 quantizer and the batcher's merge/regroup are all bit-identical to
the JAX package's, and to the port's plain (numpy) versions.
"""

import ctypes
import os
import subprocess
import sys
import textwrap
import uuid
from pathlib import Path

import numpy as np
import pytest

import hugectr_backend_tpu.ops.quantize as jq
import hugectr_backend_tpu.serving.batchpack as jbp
import hugectr_backend_tpu.tiers.hbm as jhbm
import hugectr_backend_tpu_torch.ops.quantize as tq
import hugectr_backend_tpu_torch.serving.batchpack as tbp
import hugectr_backend_tpu_torch.tiers.hbm as thbm
from hugectr_backend_tpu.config.params import DatabaseOverflowPolicy as JPolicy
from hugectr_backend_tpu.config.params import VolatileDatabaseParams as JParams
from hugectr_backend_tpu.native.kvstore import NativeDramKVTier as JaxNativeTier
from hugectr_backend_tpu.native.kvstore import SharedMemoryDramKVTier as JaxShmTier
from hugectr_backend_tpu_torch.config.params import (
    DatabaseOverflowPolicy,
    DatabaseType,
    VolatileDatabaseParams,
)
from hugectr_backend_tpu_torch.native import kvstore
from hugectr_backend_tpu_torch.tiers.dram import DramKVTier, make_dram_tier

ROOT = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ------------------------------------------------------------ key index


def _table_keys(kind, rng, n):
    if kind == "random64":
        return rng.choice(np.iinfo(np.int64).max, size=n, replace=False).astype(np.int64) \
            - (1 << 62)
    if kind == "dense":
        return rng.permutation(n).astype(np.int64)
    if kind == "empty":
        return np.empty(0, np.int64)
    raise ValueError(kind)


def _queries(keys, rng, n):
    """Hits, misses (negative keys, the int64 extremes, neighbours of hits)."""
    hits = keys[rng.integers(0, keys.size, n)] if keys.size else np.empty(0, np.int64)
    misses = np.concatenate([
        -1 - rng.integers(0, 1 << 40, n // 4),
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0], np.int64),
        hits[: n // 4] + 1,
    ])
    q = np.concatenate([hits, misses])
    return q[rng.permutation(q.size)]


@pytest.mark.parametrize("kind, n", [("random64", 5000), ("random64", 1), ("dense", 3000),
                                     ("empty", 0)])
def test_key_index_bit_identical(kind, n):
    rng = np.random.default_rng(n + len(kind))
    keys = _table_keys(kind, rng, n)
    tidx, torder = thbm.KeyIndex.build(keys)
    jidx, jorder = jhbm.KeyIndex.build(keys)
    np.testing.assert_array_equal(torder, jorder)
    assert tidx.direct == jidx.direct == (kind == "dense")
    assert (tidx._native is not None) == (kind == "random64")
    q = _queries(keys, rng, 4096)
    got = tidx.lookup(q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jidx.lookup(q)).reshape(-1))
    np.testing.assert_array_equal(got, tidx.search(q))
    np.testing.assert_array_equal(tidx.lookup(q.reshape(-1, 4)), got.reshape(-1, 4))


def test_key_index_searches_past_the_native_cap(monkeypatch):
    rng = np.random.default_rng(3)
    keys = _table_keys("random64", rng, 500)
    monkeypatch.setattr(thbm, "NATIVE_INDEX_MAX_ROWS", 499)
    idx, _ = thbm.KeyIndex.build(keys)
    assert idx._native is None
    q = _queries(keys, rng, 256)
    np.testing.assert_array_equal(idx.lookup(q), jhbm.KeyIndex.build(keys)[0].lookup(q))


def test_translate_batch_bit_identical():
    """One native call over several tables (native, direct, empty and a
    table past the cap) equals per-table lookups and the JAX batch."""
    rng = np.random.default_rng(11)
    kinds = [("random64", 20_000), ("dense", 700), ("empty", 0), ("random64", 3),
             ("random64", 9000)]
    tables = [_table_keys(k, rng, n) for k, n in kinds]
    tidx = [thbm.KeyIndex.build(k)[0] for k in tables]
    jidx = [jhbm.KeyIndex.build(k)[0] for k in tables]
    queries = [_queries(k, rng, m) for k, m in zip(tables, (40_000, 100, 50, 9000, 0))]
    got = thbm.translate_indexes_batch(tidx, queries)
    want = jhbm.translate_indexes_batch(jidx, queries)
    for g, w, idx, q in zip(got, want, tidx, queries):
        np.testing.assert_array_equal(g, np.asarray(w).reshape(-1))
        np.testing.assert_array_equal(g, idx.search(q).reshape(-1))


# ------------------------------------------------------------ DRAM stores


def _op_sequence(tier, rng, dim):
    """insert / upsert / query / evict / overflow, -> what the store said."""
    said = []
    keys = rng.choice(1 << 45, size=900, replace=False).astype(np.int64) - (1 << 44)
    vecs = rng.standard_normal((900, dim)).astype(np.float32)
    tier.create_table("t", dim)
    said.append(tier.insert("t", keys[:600], vecs[:600]))
    said.append(tier.insert("t", keys[:50], vecs[:50] * 2))  # upsert
    said.append(tier.insert("t", np.repeat(keys[600:610], 2), np.repeat(vecs[600:610], 2, 0)))
    q = np.concatenate([keys[:700], -keys[:20] - 1])
    out, found = tier.query("t", q)
    said += [out, found, tier.size("t")]
    said.append(tier.evict("t", np.concatenate([keys[100:200], keys[800:810]])))
    said.append(tier.size("t"))
    said.append(np.sort(tier.keys("t")))
    # Past the overflow margin: each partition evicts down to its target.
    said.append(tier.insert("t", keys[610:], vecs[610:]))
    said.append(tier.size("t"))
    said.append(np.sort(tier.keys("t")))
    said.append(tier.query("t", keys))
    return said


def _params(cls, policy, **over):
    p = cls(num_partitions=3, overflow_margin=700, overflow_resolution_target=0.6)
    p.overflow_policy = policy
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same(list(x), list(y))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


POLICIES = ["evict_random", "evict_least_used", "evict_oldest"]


@pytest.mark.parametrize("policy", POLICIES)
def test_native_dram_tier_matches_jax(policy):
    tier = make_dram_tier(_params(VolatileDatabaseParams, DatabaseOverflowPolicy(policy)))
    assert isinstance(tier, kvstore.NativeDramKVTier)
    got = _op_sequence(tier, np.random.default_rng(5), 8)
    want = _op_sequence(JaxNativeTier(_params(JParams, JPolicy(policy))),
                        np.random.default_rng(5), 8)
    _same(got, want)
    assert got[10] < 700  # the overflow policy evicted rows


def test_native_dram_tier_matches_the_numpy_store_below_the_margin():
    """The numpy store is the native store's plain version: the same
    answers wherever no eviction policy picks victims."""
    def seq(tier):
        rng = np.random.default_rng(8)
        keys = rng.choice(1 << 40, size=300, replace=False).astype(np.int64)
        vecs = rng.standard_normal((300, 4)).astype(np.float32)
        tier.insert("t", keys, vecs)
        tier.insert("t", keys[:30], vecs[:30] + 1)
        n = tier.evict("t", keys[200:250])
        out, found = tier.query("t", np.concatenate([keys, [-5]]))
        return [n, out, found, tier.size("t"), np.sort(tier.keys("t"))]

    p = VolatileDatabaseParams(num_partitions=4)
    _same(seq(make_dram_tier(p)), seq(DramKVTier(p)))


@pytest.mark.parametrize("vtype", ["hash_map", "parallel_hash_map", "disabled"])
def test_make_dram_tier_is_native(vtype):
    p = VolatileDatabaseParams()
    p.type = DatabaseType(vtype)
    assert isinstance(make_dram_tier(p), kvstore.NativeDramKVTier)


def test_redis_cluster_still_raises():
    p = VolatileDatabaseParams()
    p.type = DatabaseType.REDIS_CLUSTER
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        make_dram_tier(p)


_SHM_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    from hugectr_backend_tpu_torch.config.params import DatabaseType, VolatileDatabaseParams
    from hugectr_backend_tpu_torch.tiers.dram import make_dram_tier

    name, dim = sys.argv[1], int(sys.argv[2])
    keys = np.asarray(json.loads(sys.argv[3]), np.int64)
    p = VolatileDatabaseParams(num_partitions=3, overflow_margin=int(sys.argv[4]),
                               shared_memory_size=int(sys.argv[5]))
    p.type = DatabaseType.MULTI_PROCESS_HASH_MAP
    p.shared_memory_name = name
    p.shared_memory_auto_remove = False  # the parent owns the segment
    tier = make_dram_tier(p)
    tier.create_table("t", dim)  # attaches to the parent's segment
    out, found = tier.query("t", keys)
    tier.insert("t", keys + 10**12, out * 3)
    tier.close()
    print(json.dumps({"found": found.tolist(), "out": out.tolist()}))
""")


@pytest.mark.skipif(not Path("/dev/shm").is_dir(), reason="/dev/shm not available")
@pytest.mark.parametrize("policy", POLICIES)
def test_shm_tier_matches_jax_and_is_shared_across_processes(policy):
    import json

    names = [f"hps_ttest_{uuid.uuid4().hex[:12]}" for _ in range(2)]
    over = dict(shared_memory_auto_remove=True, shared_memory_size=64 << 20)
    p = _params(VolatileDatabaseParams, DatabaseOverflowPolicy(policy),
                shared_memory_name=names[0], **over)
    p.type = DatabaseType.MULTI_PROCESS_HASH_MAP
    tier = make_dram_tier(p)
    jtier = JaxShmTier(_params(JParams, JPolicy(policy), shared_memory_name=names[1], **over))
    assert isinstance(tier, kvstore.SharedMemoryDramKVTier)
    try:
        got = _op_sequence(tier, np.random.default_rng(6), 8)
        _same(got, _op_sequence(jtier, np.random.default_rng(6), 8))
        keys = np.sort(tier.keys("t"))[:50]
        r = subprocess.run([sys.executable, "-c", _SHM_CHILD, names[0], "8",
                            json.dumps(keys.tolist()), str(p.overflow_margin),
                            str(p.shared_memory_size)],
                           cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        child = json.loads(r.stdout.strip().splitlines()[-1])
        want, found = tier.query("t", keys)
        assert all(child["found"]) and found.all()
        np.testing.assert_array_equal(np.asarray(child["out"], np.float32), want)
        back, found = tier.query("t", keys + 10**12)
        assert found.all()
        np.testing.assert_array_equal(back, want * 3)
    finally:
        tier.close()
        jtier.close()


# ------------------------------------------------------------ quantizer


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("rows, dim, ordered", [(1, 16, False), (37, 36, True),
                                                (40_000, 128, True), (0, 8, False)])
def test_quantizer_bit_identical(mode, rows, dim, ordered):
    rng = np.random.default_rng(rows + dim)
    v = (rng.standard_normal((rows, dim)) * rng.uniform(0.01, 10, (rows, 1))).astype(np.float32)
    if rows > 2:
        v[1] = 0.0  # an all-zero row
        v[2, :4] = [0.5, -0.5, 1.5, -2.5]  # half-integers at scale 1
    order = rng.permutation(rows) if ordered else None
    native = {"int8": tq.quantize_rows_int8, "int4": tq.quantize_rows_int4}[mode]
    plain = {"int8": tq.quantize_rows_int8_ref, "int4": tq.quantize_rows_int4_ref}[mode]
    jax_fn = {"int8": jq.quantize_rows_int8, "int4": jq.quantize_rows_int4}[mode]
    q, s = native(v, order=order)
    for wq, ws in (plain(v, order=order), jax_fn(v, order=order)):
        np.testing.assert_array_equal(q, wq)
        np.testing.assert_array_equal(s.view(np.uint32), ws.view(np.uint32))
    assert q.dtype == (np.int8 if mode == "int8" else np.uint8)


def test_quantizer_refuses_bad_input():
    v = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError, match="even"):
        tq.quantize_rows_int4(v)
    with pytest.raises(IndexError):
        tq.quantize_rows_int8(v, order=np.array([0, 4]))


# ------------------------------------------------------------ batchpack


@pytest.mark.parametrize("n_reqs, n_tables", [(1, 3), (5, 26), (17, 1)])
def test_merge_and_regroup_bit_identical(n_reqs, n_tables):
    rng = np.random.default_rng(n_reqs * 100 + n_tables)
    counts = rng.integers(0, 9, (n_reqs, n_tables)).astype(np.int64)
    keys = [rng.integers(-(1 << 60), 1 << 60, int(c.sum())).astype(np.int64) for c in counts]
    got = tbp.merge_requests(keys, counts)
    for want in (tbp.merge_requests_ref(keys, counts), jbp.merge_requests(keys, counts)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    dims = rng.integers(1, 20, n_tables).astype(np.int64)
    pads = counts.sum(axis=0) + rng.integers(0, 5, n_tables)
    tstarts = np.concatenate([[0], np.cumsum(pads * dims)[:-1]]).astype(np.int64)
    flat = rng.standard_normal(int((pads * dims).sum())).astype(np.float32)
    out, offs = tbp.regroup_responses(flat, tstarts, dims, counts)
    for wout, woffs in (tbp.regroup_responses_ref(flat, tstarts, dims, counts),
                        jbp.regroup_responses(flat, tstarts, dims, counts)):
        np.testing.assert_array_equal(out.view(np.uint32), wout.view(np.uint32))
        np.testing.assert_array_equal(offs, woffs)


def test_regroup_refuses_a_short_flat():
    with pytest.raises(ValueError, match="past the end"):
        tbp.regroup_responses(np.zeros(5, np.float32), np.array([0]), np.array([2]),
                              np.array([[3]]))


# ------------------------------------------------------------ the build


_BUILD_CHILD = textwrap.dedent("""
    import ctypes, sys
    from pathlib import Path
    from hugectr_backend_tpu_torch.native import kvstore
    path = kvstore.build(Path(sys.argv[1]))
    lib = kvstore.bind(ctypes.CDLL(str(path)))
    h = lib.hps_kv_create(4, 2, 1 << 40, 0, 0.8)
    assert h and lib.hps_kv_size(h) == 0
    lib.hps_kv_destroy(h)
    print(path)
""")


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(tmp_path)], cwd=ROOT,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [Path(paths.pop()).name]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    for name in kvstore.SOURCES:
        (tmp_path / name).write_text("this is not C++\n")
    monkeypatch.setattr(kvstore, "_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kvstore.build(tmp_path / "_build")
    assert not list((tmp_path / "_build").iterdir())


def test_the_port_loads_its_own_library_only():
    code = textwrap.dedent("""
        import numpy as np
        from hugectr_backend_tpu_torch.tiers.hbm import KeyIndex
        from hugectr_backend_tpu_torch.native.kvstore import target
        idx, _ = KeyIndex.build(np.array([5, 9, -3], np.int64))
        assert idx._native is not None
        maps = open("/proc/self/maps").read()
        assert str(target()) in maps, "the port's library is not mapped"
        assert "hugectr_backend_tpu/native/libhps_native.so" not in maps
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert kvstore.target().parent == ROOT / "hugectr_backend_tpu_torch" / "_build"
    assert isinstance(kvstore.load_lib(), ctypes.CDLL)
